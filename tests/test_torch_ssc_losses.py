"""The port's stage-2 losses against the JAX package's on the CPU.

Inputs are seeded numpy arrays that both sides read. Tolerances: each loss
2e-6 relative (f32 sums of ~1e3 terms in another order: on the take_grad
SmoothL1 case the JAX package's own sum lies 1.13e-6 off the float64 value
of the same f32 terms, the port's 1e-8), the accuracy metrics exactly
(sums of 0/1 over their counts), the contrastive loss's gradient 1e-5 of
its largest entry (a backward through the normalisation, the logits'
matmul and the log-softmax in another order). ``bin_depths``,
``remap_labels_per_batch`` and ``capped_class_sample`` to the bit: the
sampling's priorities are fed to both sides (a test-local
``jax.random.uniform`` returns them), because torch cannot draw
``jax.random.uniform``'s bits.
"""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from creste_public_tpu.config import presets as jpresets
from creste_public_tpu.losses import manager as jmanager
from creste_public_tpu.losses import supcon as jsupcon
from creste_public_tpu.utils import depth as jdepth
from creste_public_tpu_torch.losses import manager, supcon
from creste_public_tpu_torch.utils import depth

LOSS_RTOL = 2e-6
GRAD_RTOL = 1e-5


def _fed_uniform(pri: np.ndarray):
    """A ``jax.random.uniform`` that returns ``pri``."""
    def uniform(key, shape, *args, **kwargs):
        assert tuple(shape) == pri.shape
        return jnp.asarray(pri)
    return uniform


def _close(got, want, rtol=LOSS_RTOL, what=""):
    got = float(got.detach()) if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, float(want), rtol=rtol, atol=1e-7,
                               err_msg=what)


@pytest.mark.parametrize("mode", ["UD", "LID", "SID"])
def test_bin_depths_matches_jax(mode):
    rng = np.random.default_rng(0)
    d = rng.uniform(-500, 30000, size=(3, 17, 23)).astype(np.float32)
    d[0, 0, :4] = [np.nan, np.inf, -np.inf, 300.0]
    d[1, 1, :3] = [25600.0, 0.0, 299.99]
    for target in (True, False):
        want = np.asarray(jdepth.bin_depths(jnp.asarray(d), mode, 300.0,
                                            25600.0, 128, target=target))
        got = depth.bin_depths(torch.from_numpy(d), mode, 300.0, 25600.0,
                               128, target=target).numpy()
        assert got.dtype == want.dtype
        if target or mode == "UD":
            np.testing.assert_array_equal(got, want)
        else:  # torch's log and sqrt and XLA's may round apart by an ulp
            np.testing.assert_allclose(got, want, rtol=1e-6)
    assert (depth.bin_depths(torch.from_numpy(d), mode, 300.0, 25600.0, 128,
                             target=True)[0, 0, :3] == 128).all()


def test_remap_labels_per_batch_matches_jax():
    lab = np.random.default_rng(1).integers(0, 9, size=(4, 6, 5),
                                            dtype=np.int32)
    want = np.asarray(jsupcon.remap_labels_per_batch(jnp.asarray(lab)))
    got = supcon.remap_labels_per_batch(torch.from_numpy(lab)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[lab == 0] == 0).all() and got.max() >= 3 * 2 ** 20


def _sample_case(name):
    """(labels, valid, priorities, max_samples, cap, use_median)."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    if name == "many_classes":
        n = 6000
        labels = (rng.zipf(1.6, size=n) % 400).astype(np.int32)
        valid = rng.uniform(size=n) > 0.2
        return labels, valid, rng.uniform(size=n), 512, 1000, True
    if name == "few_kept":
        n = 300
        labels = rng.integers(0, 5, size=n).astype(np.int32)
        valid = rng.uniform(size=n) > 0.5
        return labels, valid, rng.uniform(size=n), 2048, 1000, True
    if name == "even_classes":
        # four classes of sizes 1, 3, 5, 7: the lower median is 3
        labels = np.repeat(np.arange(4, dtype=np.int32) * 7 + 2,
                           [1, 3, 5, 7])
        perm = rng.permutation(len(labels))
        labels = labels[perm]
        valid = np.ones(len(labels), bool)
        return labels, valid, rng.uniform(size=len(labels)), 64, 1000, True
    if name == "ties_and_cap":
        # coarse priorities tie often (index order decides), and the cap
        # is below the median
        n = 2000
        labels = rng.integers(0, 12, size=n).astype(np.int32)
        valid = rng.uniform(size=n) > 0.1
        pri = np.floor(rng.uniform(size=n) * 4) / 4
        return labels, valid, pri, 256, 7, True
    if name == "no_median":
        n = 1500
        labels = rng.integers(0, 40, size=n).astype(np.int32)
        valid = rng.uniform(size=n) > 0.3
        return labels, valid, rng.uniform(size=n), 700, 20, False
    if name == "none_valid":
        n = 50
        labels = rng.integers(0, 3, size=n).astype(np.int32)
        return labels, np.zeros(n, bool), rng.uniform(size=n), 16, 1000, True
    raise KeyError(name)


@pytest.mark.parametrize("case", ["many_classes", "few_kept", "even_classes",
                                  "ties_and_cap", "no_median", "none_valid"])
@pytest.mark.parametrize("fed", [True, False], ids=["fed", "rng_none"])
def test_capped_class_sample_bit_for_bit(case, fed, monkeypatch):
    labels, valid, pri, m, cap, use_median = _sample_case(case)
    pri = pri.astype(np.float32)
    monkeypatch.setattr(jax.random, "uniform", _fed_uniform(pri))
    idx, sel = jsupcon.capped_class_sample(
        jnp.asarray(labels), jnp.asarray(valid), m, cap=cap,
        rng=jax.random.PRNGKey(0) if fed else None, use_median=use_median)
    got_idx, got_sel = supcon.capped_class_sample(
        torch.from_numpy(labels), torch.from_numpy(valid), m, cap=cap,
        rng=torch.from_numpy(pri) if fed else None, use_median=use_median)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(idx))
    np.testing.assert_array_equal(got_sel.numpy(), np.asarray(sel))
    assert got_idx.shape == (m,)
    if case == "even_classes":
        # min(lower median 3, cap) per class: 1 + 3 + 3 + 3
        assert int(got_sel.sum()) == 10
    if case == "few_kept":
        assert int(got_sel.sum()) < m


def test_capped_class_sample_generator_source():
    """A torch.Generator source draws torch.rand(N) from it: the same
    selection as those priorities fed."""
    labels, valid, _, m, cap, _ = _sample_case("many_classes")
    lab, val = torch.from_numpy(labels), torch.from_numpy(valid)
    pri = torch.rand(len(labels), generator=torch.Generator().manual_seed(3))
    a = supcon.capped_class_sample(lab, val, m, cap,
                                   rng=torch.Generator().manual_seed(3))
    b = supcon.capped_class_sample(lab, val, m, cap, rng=pri)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    with pytest.raises(ValueError, match="priorities of shape"):
        supcon.capped_class_sample(lab, val, m, cap, rng=pri[:5])


def _con_inputs(weights: bool):
    rng = np.random.default_rng(5)
    M, Z = 96, 12
    feats = rng.normal(size=(M, Z)).astype(np.float32)
    feats[3] = 0.0  # a zero feature vector: the eps-safe normalisation
    labels = rng.integers(0, 7, size=M).astype(np.int32)
    valid = rng.uniform(size=M) > 0.15
    cw = (rng.uniform(0.2, 2.0, size=5).astype(np.float32) if weights
          else None)
    return feats, labels, valid, cw


@pytest.mark.parametrize("weights", [False, True])
def test_multi_pos_con_loss_and_grad_match_jax(weights):
    feats, labels, valid, cw = _con_inputs(weights)

    def jloss(f):
        return jsupcon.multi_pos_con_loss(
            f, jnp.asarray(labels), jnp.asarray(valid), 0.1,
            None if cw is None else jnp.asarray(cw))

    want, want_g = jax.value_and_grad(jloss)(jnp.asarray(feats))
    f = torch.from_numpy(feats).requires_grad_(True)
    got = supcon.multi_pos_con_loss(
        f, torch.from_numpy(labels), torch.from_numpy(valid), 0.1,
        None if cw is None else torch.from_numpy(cw))
    got.backward()
    _close(got, want)
    want_g = np.asarray(want_g)
    d = np.abs(f.grad.numpy() - want_g).max()
    assert d <= GRAD_RTOL * np.abs(want_g).max(), d
    assert np.isfinite(f.grad.numpy()).all()


def _depth_td(rng):
    B, S, H, W, D = 2, 1, 16, 20, 16
    gt = rng.uniform(0, 3500, size=(B, S, H, W)).astype(np.float32)
    gt[0, 0, :2, :3] = 0.0  # no return
    gt[1, 0, 5, 5] = np.nan
    return {
        "outputs/depth_preds_logits": rng.normal(
            size=(B * S, H // 2, W // 2, D)).astype(np.float32) * 3,
        "outputs/depth_preds_metric": rng.uniform(
            0, 3.5, size=(B * S, H // 2, W // 2)).astype(np.float32),
        "inputs/depth_label": gt,
    }


def _bev_td(rng, dyn_classes=6, sam_dim=8):
    B, H, W = 2, 12, 14
    elev = rng.normal(size=(B, H, W, 2)).astype(np.float32)
    elev[0, 1, 1, 0] = np.nan
    elev[1, 2, 3, 1] = np.inf
    fimg = rng.normal(size=(B, 1, 6, 7, 5)).astype(np.float32)
    fimg[0, 0, 0, 0, :2] = np.inf
    sam = rng.integers(0, 6, size=(B, H, W)).astype(np.int32)
    dyn = np.zeros((B, H, W, 3), np.float32)
    dyn[..., 1] = rng.integers(0, dyn_classes, size=(B, H, W))
    dyn[..., 0] = rng.uniform(size=(B, H, W))
    return {
        "outputs/inpainting_sam_preds": rng.normal(
            size=(B, H, W, sam_dim)).astype(np.float32),
        "outputs/inpainting_sam_dynamic_preds": rng.normal(
            size=(B, H, W, dyn_classes)).astype(np.float32),
        "outputs/elevation_preds": rng.normal(
            size=(B, H, W, 2)).astype(np.float32),
        "outputs/dino_pe_feats": rng.normal(
            size=(B, 1, 6, 7, 5)).astype(np.float32),
        "inputs/fimg_label": fimg,
        "inputs/3d_sam_label": sam,
        "inputs/3d_sam_dynamic_label": dyn,
        "inputs/elevation_label": elev,
        "inputs/fov_mask": rng.uniform(size=(B, H, W)) > 0.25,
    }


def _run_both(cfg, td, aux_j=None, aux_t=None):
    jl = jmanager._REGISTRY[cfg["name"]](cfg)
    tl = manager.make_loss(cfg)
    want_l, want_m = jl({k: jnp.asarray(v) for k, v in td.items()}, aux_j)
    got_l, got_m = tl({k: torch.from_numpy(np.asarray(v))
                       for k, v in td.items()}, aux_t)
    assert got_l.keys() == want_l.keys() and got_m.keys() == want_m.keys()
    for k, (w, v) in want_l.items():
        assert got_l[k][0] == w, k
        _close(got_l[k][1], v, what=k)
    for k, v in want_m.items():  # accuracies: exactly
        assert float(got_m[k]) == float(v), k
    return got_l, got_m


_DISC = {"mode": "UD", "num_bins": 16, "depth_min": 300, "depth_max": 3200}


@pytest.mark.parametrize("cfg", [
    {"name": "CrossEntropyDepth", "weight": 0.5,
     "pred_key": "outputs/depth_preds_logits",
     "lab_key": "inputs/depth_label", "discretize": _DISC},
    {"name": "SmoothL1Depth", "weight": 0.1,
     "pred_key": "outputs/depth_preds_metric",
     "lab_key": "inputs/depth_label", "beta": 0.5, "discretize": _DISC},
], ids=lambda c: c["name"])
def test_depth_losses_match_jax(cfg):
    _run_both(cfg, _depth_td(np.random.default_rng(2)))


@pytest.mark.parametrize("absolute", [False, True])
@pytest.mark.parametrize("take_grad", [False, True])
def test_smooth_l1_matches_jax(absolute, take_grad):
    cfg = {"name": "SmoothL1", "weight": 3.0, "beta": 0.2,
           "pred_key": "outputs/elevation_preds",
           "lab_key": "inputs/elevation_label", "absolute": absolute,
           "take_grad": take_grad, "task": "joint"}
    _run_both(cfg, _bev_td(np.random.default_rng(3)))


def test_mse_loss_matches_jax():
    cfg = {"name": "MSELoss", "weight": 2.0,
           "pred_key": "outputs/dino_pe_feats",
           "lab_key": "inputs/fimg_label", "overlap_only": False}
    got, _ = _run_both(cfg, _bev_td(np.random.default_rng(4)))
    assert np.isfinite(float(got["loss"][1]))
    # the BEV-overlap variant at one view is the anchor view's MSE
    td = _bev_td(np.random.default_rng(4))
    td["outputs/bev_coords"] = np.zeros((2, 6 * 7, 2), np.float32)
    over, _ = _run_both(dict(cfg, overlap_only=True), td)
    assert float(over["loss"][1]) == pytest.approx(float(got["loss"][1]),
                                                   rel=1e-6)


@pytest.mark.parametrize("variant", ["class_dim", "argmax", "ignore",
                                     "class_weights"])
def test_cross_entropy_matches_jax(variant, tmp_path):
    cfg = {"name": "CrossEntropy", "weight": 2.0,
           "pred_key": "outputs/inpainting_sam_dynamic_preds",
           "lab_key": "inputs/3d_sam_dynamic_label", "num_class": 6,
           "class_dim": 1, "task": "joint"}
    td = _bev_td(np.random.default_rng(6), dyn_classes=3)
    td["outputs/inpainting_sam_dynamic_preds"] = td[
        "outputs/inpainting_sam_dynamic_preds"][..., :3]
    if variant == "argmax":
        cfg["class_dim"] = -1
    if variant == "ignore":
        cfg["ignore_index"] = 2
    if variant == "class_weights":
        path = tmp_path / "freq.txt"
        np.savetxt(path, [0.5, 0.3, 0.2])
        cfg["class_weights"] = str(path)
    _run_both(cfg, td)


@pytest.mark.parametrize("weights", [False, True])
def test_sup_pixel_con_loss_and_grad_match_jax(weights, tmp_path,
                                               monkeypatch):
    cfg = {"name": "SupPixelConLoss", "views": 1, "weight": 1.0,
           "pred_key": "outputs/inpainting_sam_preds",
           "lab_key": "inputs/3d_sam_label", "ignore_index": 0,
           "temperature": 0.1, "task": "joint", "max_samples": 128}
    if weights:
        path = tmp_path / "freq.txt"
        np.savetxt(path, np.linspace(0.1, 0.9, 6))
        cfg["class_weights"] = str(path)
    td = _bev_td(np.random.default_rng(7))
    n = td["inputs/3d_sam_label"].size
    pri = np.random.default_rng(8).uniform(size=n).astype(np.float32)
    monkeypatch.setattr(jax.random, "uniform", _fed_uniform(pri))
    key = "outputs/inpainting_sam_preds"

    def jloss(p):
        jtd = {k: jnp.asarray(v) for k, v in td.items()}
        jtd[key] = p
        ld, _ = jmanager._REGISTRY[cfg["name"]](cfg)(
            jtd, {"rng": jax.random.PRNGKey(0)})
        return jmanager.LossManager.total(ld), ld

    (want, want_l), want_g = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(td[key]))
    ttd = {k: torch.from_numpy(np.asarray(v)) for k, v in td.items()}
    ttd[key].requires_grad_(True)
    got_l, got_m = manager.make_loss(cfg)(ttd, {"rng": torch.from_numpy(pri)})
    assert got_l.keys() == want_l.keys() and not got_m
    assert "joint/3d_sam_label/supcon/sem_loss" in got_l
    total = manager.LossManager.total(got_l)
    total.backward()
    _close(total, want)
    want_g = np.asarray(want_g)
    d = np.abs(ttd[key].grad.numpy() - want_g).max()
    assert d <= GRAD_RTOL * np.abs(want_g).max(), d
    assert np.abs(want_g).max() > 0
    # across devices (tests/test_torch_supcon_gather.py gathers over
    # ranks): a group of one rank gives the single-device loss and gradient
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        g1 = {k: v.detach().clone().requires_grad_(k == key)
              for k, v in ttd.items()}
        one = manager.LossManager.total(manager.make_loss(cfg)(
            g1, {"rng": torch.from_numpy(pri), "group": dist.group.WORLD})[0])
        one.backward()
    finally:
        dist.destroy_process_group()
    assert torch.equal(one.detach(), total.detach())
    assert torch.equal(g1[key].grad, ttd[key].grad)


def test_loss_manager_stage2_preset_matches_jax(monkeypatch):
    """The tiny stage-2 preset's six losses through LossManager, the task
    filter on ``joint``: the same keys and values."""
    cfg = jpresets.tiny_terrainnet_config().to_dict()
    rng = np.random.default_rng(9)
    td = dict(_bev_td(rng), **_depth_td(rng))
    td["outputs/depth_preds_logits"] = td["outputs/depth_preds_logits"][
        ..., :16]
    n = td["inputs/3d_sam_label"].size
    pri = rng.uniform(size=n).astype(np.float32)
    monkeypatch.setattr(jax.random, "uniform", _fed_uniform(pri))
    for task in ("joint", None):
        jtd = {k: jnp.asarray(v) for k, v in td.items()}
        ttd = {k: torch.from_numpy(np.asarray(v)) for k, v in td.items()}
        if task:
            jtd["task"] = ttd["task"] = task
        want_l, want_m = jmanager.LossManager(cfg)(
            jtd, {"rng": jax.random.PRNGKey(0)})
        got_l, got_m = manager.LossManager(cfg)(
            ttd, {"rng": torch.from_numpy(pri)})
        assert sorted(got_l) == sorted(want_l)
        assert sorted(got_m) == sorted(want_m)
        for k, (w, v) in want_l.items():
            _close(got_l[k][1], v, what=k)
        _close(manager.LossManager.total(got_l),
               jmanager.LossManager.total(want_l))
        assert len(got_l) == (7 if task else 3)
    # every loss of the JAX registry builds in the port
    assert sorted(manager._REGISTRY) == sorted(jmanager._REGISTRY)
