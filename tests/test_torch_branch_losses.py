"""The port's last five losses against the JAX package's on the CPU:
``FocalLoss``, ``BCActionLoss``, ``TREXLoss``, ``bal_contrastive_loss``
with ``BalancedContrastiveLoss`` and ``VicregLoss``.

Inputs are seeded numpy arrays that both sides read. Tolerances: each loss
value and metadata entry 2e-6 relative (f32 sums of up to ~1e4 terms in
another order, as ``tests/test_torch_ssc_losses.py`` holds the stage-2
losses), accuracies exactly (sums of 0/1 over their counts), each gradient
against ``jax.grad`` to 1e-5 of its largest entry (a backward through
softmaxes, logs and matmuls in another order). The samplers' priorities
are fed to both sides: a test-local ``jax.random.uniform`` returns them by
shape (VICReg's per-element draws run under ``jax.vmap``, so every element
gets the same fed row), because torch cannot draw JAX's bits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from creste_public_tpu.losses import balancedsupcon as jbal
from creste_public_tpu.losses import manager as jmanager
from creste_public_tpu_torch.losses import balancedsupcon as bal
from creste_public_tpu_torch.losses import manager
from tests.test_torch_step_helpers import (
    one_torch_thread,  # noqa: F401 (an autouse fixture)
)

LOSS_RTOL = 2e-6
GRAD_RTOL = 1e-5
KEY = jax.random.PRNGKey(0)


def _fed_uniform(by_shape: dict):
    """A ``jax.random.uniform`` that returns the fed array of the asked
    shape."""
    def uniform(key, shape, *args, **kwargs):
        return jnp.asarray(by_shape[tuple(shape)])
    return uniform


def _close(got, want, rtol=LOSS_RTOL, what=""):
    got = float(got.detach()) if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, float(want), rtol=rtol, atol=1e-7,
                               err_msg=what)


def _grad_close(got: torch.Tensor, want, what=""):
    want = np.asarray(want)
    assert np.abs(want).max() > 0, what
    d = np.abs(got.numpy() - want).max()
    assert d <= GRAD_RTOL * np.abs(want).max(), (what, d)


def _jtree(x):
    if isinstance(x, dict):
        return {k: _jtree(v) for k, v in x.items()}
    return jnp.asarray(x)


def _ttree(x):
    if isinstance(x, dict):
        return {k: _ttree(v) for k, v in x.items()}
    return torch.from_numpy(np.asarray(x))


def _run_both(cfg, td, grad_key, aux_j=None, aux_t=None):
    """The loss through both registries: every key, weight and value, the
    metadata, and the gradient of the weighted total at ``grad_key``."""
    jl = jmanager._REGISTRY[cfg["name"]](cfg)

    def jloss(p):
        jtd = _jtree(td)
        jtd[grad_key] = p
        ld, meta = jl(jtd, aux_j)
        return jmanager.LossManager.total(ld), (ld, meta)

    (want, (want_l, want_m)), want_g = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(jnp.asarray(td[grad_key]))
    ttd = _ttree(td)
    ttd[grad_key].requires_grad_(True)
    got_l, got_m = manager.make_loss(cfg)(ttd, aux_t)
    assert got_l.keys() == want_l.keys() and got_m.keys() == want_m.keys()
    for k, (w, v) in want_l.items():
        assert got_l[k][0] == w, k
        _close(got_l[k][1], v, what=k)
    for k, v in want_m.items():
        if k.endswith("acc"):
            assert float(got_m[k]) == float(v), k
        else:
            _close(got_m[k], v, what=k)
    total = manager.LossManager.total(got_l)
    total.backward()
    _close(total, want)
    _grad_close(ttd[grad_key].grad, want_g, grad_key)
    return got_l, got_m


def _sem_td(rng, B=2, H=12, W=14, C=5):
    gt = rng.uniform(size=(B, H, W, C)).astype(np.float32)
    gt[..., 2] = rng.integers(0, C, size=(B, H, W))
    return {"outputs/inpainting_sem_preds": rng.normal(
                size=(B, H, W, C)).astype(np.float32) * 2,
            "inputs/3d_ssc_label": gt,
            "inputs/fov_mask": rng.uniform(size=(B, H, W)) > 0.25}


@pytest.mark.parametrize("variant", ["argmax", "class_dim", "ignore",
                                     "class_weights"])
def test_focal_loss_and_grad_match_jax(variant, tmp_path):
    cfg = {"name": "FocalLoss", "weight": 1.5, "alpha": 0.3, "gamma": 2.0,
           "pred_key": "outputs/inpainting_sem_preds",
           "lab_key": "inputs/3d_ssc_label", "task": "joint"}
    if variant == "class_dim":
        cfg["class_dim"] = 2
    if variant == "ignore":
        cfg["ignore_index"] = 1
    if variant == "class_weights":
        path = tmp_path / "freq.txt"
        np.savetxt(path, [0.4, 0.2, 0.2, 0.1, 0.1])
        cfg["class_weights"] = str(path)
    _, meta = _run_both(cfg, _sem_td(np.random.default_rng(1)),
                        "outputs/inpainting_sem_preds")
    assert "joint/FocalLoss/acc" in meta


def _expert(rng, B=3, T=9):
    """[B, T, 3, 3] expert SE(2) poses whose steps include exact ties
    between actions: a zero step (four actions at 1), a (0.5, 0.5) step
    (three at sqrt(0.5)) and a (-0.5, 0) step (three at sqrt(1.25))."""
    # steps on a 1/8 grid from integer starts: the positions and their
    # differences are exact in f32
    steps = np.round(rng.normal(size=(B, T - 1, 2)) * 8) / 8
    steps[0, 0] = (0.0, 0.0)
    steps[0, 1] = (0.5, 0.5)
    steps[1, 2] = (-0.5, 0.0)
    start = rng.integers(0, 20, size=(B, 1, 2))
    xy = np.concatenate([start, start + np.cumsum(steps, 1)],
                        1).astype(np.float32)
    gt = np.tile(np.eye(3, dtype=np.float32), (B, T, 1, 1))
    gt[:, :, :2, 2] = xy
    return gt


def test_bc_action_loss_and_grad_match_jax():
    """BCE against the nearest action's one-hot; the planted ties go to
    the first action on both sides (``argmin``)."""
    rng = np.random.default_rng(2)
    gt = _expert(rng)
    d = gt[:, 1:, :2, 2] - gt[:, :-1, :2, 2]
    assert (d[0, 0] == 0).all() and (d[0, 1] == 0.5).all()
    td = {"outputs/action_preds": rng.uniform(0.01, 0.99, size=(
              3, 9, 8)).astype(np.float32),
          "inputs/traversability_label": gt}
    td["outputs/action_preds"][1, 3, 2] = 1.0  # clipped at 1 - 1e-7
    cfg = {"name": "BCActionLoss", "weight": 0.7,
           "pred_key": "outputs/action_preds",
           "lab_key": "inputs/traversability_label"}
    _run_both(cfg, td, "outputs/action_preds")


def _cf(rng, B=4, N=5, T=7):
    """Counterfactuals with P preferred and Q other valid entries per
    element: (1, 3), (2, 2) (gcd > 1: the repeat pairing is not the
    Cartesian product), (2, 3), and (0, 2) (no pair)."""
    traj = rng.uniform(-4, 140, size=(B, N, T, 2)).astype(np.float32)
    traj[0, 0, 0] = (2.0, 3.0)  # x.5 rounds half to even on both sides
    traj[0, 0, 1] = (6.0, 5.0)
    rank = np.array([[0, 1, 2, 1, 3], [0, 2, 0, 1, 0],
                     [1, 0, 2, 0, 1], [1, 2, 0, 0, 3]], np.int32)
    valid = np.array([[1, 1, 1, 1, 0], [1, 1, 1, 1, 0],
                      [1, 1, 1, 1, 1], [1, 1, 0, 0, 0]], bool)
    return {"trajectories": traj, "rank": rank, "valid": valid}


def test_trex_loss_and_grad_match_jax():
    rng = np.random.default_rng(3)
    td = {"outputs/traversability_preds": rng.normal(
              size=(4, 64, 128, 1)).astype(np.float32),
          "inputs/counterfactuals_label": _cf(rng)}
    cfg = {"name": "TREXLoss", "weight": 1.0, "l1_reg": 0.1,
           "pred_key": "outputs/traversability_preds",
           "lab_key": "inputs/counterfactuals_label"}
    _run_both(cfg, td, "outputs/traversability_preds")


def _bal_inputs(seed=5, B=24, V=3, Z=8):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(B, V, Z)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
    labels = rng.integers(0, 4, size=B).astype(np.int32)
    labels[5] = 9  # a row with no positive
    valid = rng.uniform(size=B) > 0.25
    return feats, labels, valid


@pytest.mark.parametrize("loss_type", ["l_spread", "sup_con", "l_repel",
                                       "sim_clr"])
@pytest.mark.parametrize("masked", [False, True])
def test_bal_contrastive_loss_and_grad_match_jax(loss_type, masked):
    feats, labels, valid = _bal_inputs()

    def jloss(f):
        return jbal.bal_contrastive_loss(
            f, jnp.asarray(labels), temperature=0.5, a_lc=0.7, a_spread=1.3,
            loss_type=loss_type, valid=jnp.asarray(valid) if masked else None)

    want, want_g = jax.jit(jax.value_and_grad(jloss))(jnp.asarray(feats))
    f = torch.from_numpy(feats).requires_grad_(True)
    got = bal.bal_contrastive_loss(
        f, torch.from_numpy(labels), temperature=0.5, a_lc=0.7, a_spread=1.3,
        loss_type=loss_type, valid=torch.from_numpy(valid) if masked else None)
    got.backward()
    _close(got, want)
    _grad_close(f.grad, want_g)


def test_bal_contrastive_oracles():
    """The JAX package's own checks (tests/test_secondary_models.py): the
    supervised term prefers class-aligned features, the multiview loss is
    finite, and padded rows (valid False) do not change the loss."""
    rng = np.random.default_rng(0)
    labels = torch.from_numpy(np.repeat([0, 1, 2], 6))
    centers = rng.normal(size=(3, 8))
    aligned = centers[labels.numpy()] + 0.05 * rng.normal(size=(18, 8))
    shuffled = rng.normal(size=(18, 8))

    def unit(x):
        x = x / np.linalg.norm(x, axis=-1, keepdims=True)
        return torch.from_numpy(x.astype(np.float32))

    la = bal.bal_contrastive_loss(unit(aligned)[:, None], labels,
                                  loss_type="sup_con")
    ls = bal.bal_contrastive_loss(unit(shuffled)[:, None], labels,
                                  loss_type="sup_con")
    assert float(la) < float(ls)
    feats = unit(rng.normal(size=(6, 3, 8)))
    assert np.isfinite(float(bal.bal_contrastive_loss(
        feats, torch.tensor([0, 0, 1, 1, 2, 2]))))
    lab6 = torch.tensor([0, 1, 0, 2, 1, 2])
    base = bal.bal_contrastive_loss(feats, lab6)
    padded = torch.cat([feats, unit(rng.normal(size=(4, 3, 8)))])
    got = bal.bal_contrastive_loss(
        padded, torch.cat([lab6, torch.tensor([0, 1, 2, 0])]),
        valid=torch.tensor([True] * 6 + [False] * 4))
    _close(got, float(base))


@pytest.mark.parametrize("views", [1, 2])
def test_balanced_contrastive_loss_matches_jax(views, monkeypatch):
    rng = np.random.default_rng(6)
    B, H, W, Z = 2, 10, 12, 6
    td = {"outputs/inpainting_sam_preds": rng.normal(
              size=(B * views, H, W, Z)).astype(np.float32),
          "inputs/3d_sam_label": rng.integers(0, 5, size=(
              B, H, W)).astype(np.int32),
          "inputs/fov_mask": rng.uniform(size=(B, H, W)) > 0.2}
    pri = rng.uniform(size=B * H * W).astype(np.float32)
    monkeypatch.setattr(jax.random, "uniform",
                        _fed_uniform({pri.shape: pri}))
    cfg = {"name": "BalancedContrastiveLoss", "weight": 0.5, "views": views,
           "pred_key": "outputs/inpainting_sam_preds",
           "lab_key": "inputs/3d_sam_label", "max_samples": 96, "cap": 20,
           "temperature": 0.5}
    _run_both(cfg, td, "outputs/inpainting_sam_preds", {"rng": KEY},
              {"rng": torch.from_numpy(pri)})


def _vicreg_td(rng, ssc: bool, B=2, H=12, W=10, Z=6):
    td = {"outputs/bev_features": rng.normal(
              size=(B, H, W, Z)).astype(np.float32),
          "outputs/bev_features_mv": rng.normal(
              size=(B, H, W, Z)).astype(np.float32),
          "inputs/fov_mask": rng.uniform(size=(B, 2 * H, 2 * W)) > 0.2}
    if ssc:
        td["inputs/3d_ssc_label"] = rng.uniform(size=(
            B, H, W, 4)).astype(np.float32)
    else:
        td["inputs/3d_sam_label"] = rng.integers(0, 5, size=(
            B, H, W, 1)).astype(np.int32)
    return td


@pytest.mark.parametrize("fed", [True, False], ids=["fed", "rng_none"])
@pytest.mark.parametrize("label", ["3d_sam_label", "3d_ssc_label"])
def test_vicreg_loss_and_grads_match_jax(fed, label, monkeypatch):
    """VICReg's value, its three terms and its gradient at both views'
    features, the budgets and caps biting (a subsample per class), the
    FOV mask resized to the features (nearest), from fed priorities or
    from none."""
    rng = np.random.default_rng(7)
    td = _vicreg_td(rng, label == "3d_ssc_label")
    B, H, W, _ = td["outputs/bev_features"].shape
    pairs = rng.uniform(size=H * W).astype(np.float32)
    var = rng.uniform(size=B * H * W).astype(np.float32)
    monkeypatch.setattr(jax.random, "uniform", _fed_uniform(
        {pairs.shape: pairs, var.shape: var}))
    cfg = {"name": "VicregLoss", "weight": 0.25, "sim_coeff": 25.0,
           "std_coeff": 25.0, "cov_coeff": 1.0,
           "pred_key": "outputs/bev_features",
           "pred_mv_key": "outputs/bev_features_mv",
           "lab_key": f"inputs/{label}", "sample_budget": 64,
           "variance_budget": 48, "max_samples_per_label": 12,
           "max_variance_samples": 7}
    aux_t = {"rng": (torch.from_numpy(np.tile(pairs, (B, 1))),
                     torch.from_numpy(var)) if fed else None}
    aux_j = {"rng": KEY if fed else None}
    for key in ("outputs/bev_features", "outputs/bev_features_mv"):
        _, meta = _run_both(cfg, td, key, aux_j, aux_t)
    assert set(meta) == {"vicreg/sim", "vicreg/std", "vicreg/cov"}
    assert all(float(v) > 0 for v in meta.values())


def test_vicreg_registered_and_sources():
    """The JAX package's check (tests/test_secondary_models.py:139): the
    loss through LossManager at its defaults, finite, with its metadata;
    a generator source equals its draws fed in order (B rows, then the
    variance row), and a plain tensor is refused."""
    cfg = {"loss": [{
        "name": "VicregLoss", "weight": 1.0,
        "pred_key": "outputs/bev_features",
        "pred_mv_key": "outputs/bev_features_mv",
        "lab_key": "inputs/3d_sam_label"}]}
    rng = np.random.default_rng(0)
    td = {"outputs/bev_features": torch.from_numpy(
              rng.normal(size=(2, 8, 8, 4)).astype(np.float32)),
          "outputs/bev_features_mv": torch.from_numpy(
              rng.normal(size=(2, 8, 8, 4)).astype(np.float32)),
          "inputs/3d_sam_label": torch.from_numpy(
              rng.integers(0, 4, size=(2, 8, 8)).astype(np.int32)),
          "inputs/fov_mask": torch.ones((2, 8, 8))}
    mgr = manager.LossManager(cfg)
    ld, meta = mgr(td)
    (_, v), = ld.values()
    assert np.isfinite(float(v)) and "VicregLoss/vicreg/sim" in meta
    small = dict(cfg["loss"][0], sample_budget=40, variance_budget=30)
    loss = manager.make_loss(small)
    g = torch.Generator().manual_seed(4)
    draws = torch.Generator().manual_seed(4)
    fed = (torch.stack([torch.rand(64, generator=draws) for _ in range(2)]),
           torch.rand(128, generator=draws))
    a, _ = loss(td, {"rng": g})
    b, _ = loss(td, {"vicreg_rng": fed, "rng": torch.zeros(3)})
    assert float(a["vicreg_loss"][1]) == float(b["vicreg_loss"][1])
    with pytest.raises(ValueError, match="vicreg_rng"):
        loss(td, {"rng": torch.zeros(128)})


def test_every_jax_loss_builds():
    """Every name of the JAX registry builds in the port's LossManager."""
    assert sorted(manager._REGISTRY) == sorted(jmanager._REGISTRY)
    assert not hasattr(manager, "_NOT_PORTED")
