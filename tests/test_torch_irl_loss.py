"""The port's stage-3 objective against the JAX package on the CPU:
trajectory rasterisation, the nearest resize-and-crop, MaxEntIRLLoss
through LossManager (with and without counterfactuals) and the reward-head
parameter gradient of the total loss, penalty included, plus the numpy
synthetic dataset.

Tolerances: rasterisation, resize and dataset exactly; the loss and its
metadata 1e-5 relative (f32 sums in another order); the gradient 1e-4
relative to each parameter's largest entry (a second-order backward through
the reward head, in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from creste_public_tpu.config import presets as jpresets
from creste_public_tpu.data.synthetic import SyntheticCodaDataset as JDataset
from creste_public_tpu.data.synthetic import collate as jcollate
from creste_public_tpu.losses.manager import LossManager as JLossManager
from creste_public_tpu.models.blocks.convnets import MultiScaleFCN as JFCN
from creste_public_tpu.ops.rasterize import rasterize_trajectory as jraster
from creste_public_tpu.utils.imageops import resize_and_crop as jresize
from creste_public_tpu_torch.data.synthetic import SyntheticCodaDataset, collate
from creste_public_tpu_torch.losses.manager import LossManager
from creste_public_tpu_torch.models.blocks.convnets import MultiScaleFCN
from creste_public_tpu_torch.ops.rasterize import rasterize_trajectory
from creste_public_tpu_torch.training.pipelines import merge_tensor_dict
from creste_public_tpu_torch.utils.imageops import resize_and_crop
from creste_public_tpu_torch.weights import from_jax_variables, load_jax_variables
from tests.test_torch_helpers import jax_variables, jitter_bn, seeded_variables

TINY = dict(image_size=(64, 80), grid=32, map_range=1.6, fdn_dim=16,
            horizon=10, length=8)


def _batch(dataset_cls, collate_fn, idx=(0, 1)):
    ds = dataset_cls(**TINY)
    return collate_fn([ds[i] for i in idx])


def test_synthetic_dataset_bit_equal_to_jax():
    ours, ref = SyntheticCodaDataset(**TINY), JDataset(**TINY)
    for i in (0, 3, 7):
        a, b = ours[i], ref[i]
        assert a.keys() == b.keys()
        for k in b:
            if isinstance(b[k], dict):
                for kk in b[k]:
                    np.testing.assert_array_equal(a[k][kk], b[k][kk])
                    assert a[k][kk].dtype == b[k][kk].dtype
            else:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
                assert a[k].dtype == b[k].dtype, k
    batch = collate([ours[0], ours[1]])
    assert batch["image"].shape == (2, 1, 64, 80, 4)
    assert batch["counterfactuals_label"]["trajectories"].shape == (2, 6, 10, 2)


@pytest.mark.parametrize("with_valid", [False, True])
def test_rasterize_matches_jax(with_valid):
    rng = np.random.default_rng(0)
    xy = rng.uniform(-4, 36, size=(3, 10, 2)).astype(np.float32)
    valid = rng.uniform(size=(3, 10)) > 0.3 if with_valid else None
    ref = np.asarray(jraster(jnp.asarray(xy), 2.0, (8, 16),
                             valid=None if valid is None
                             else jnp.asarray(valid)))
    got = rasterize_trajectory(torch.from_numpy(xy), 2.0, (8, 16),
                               valid=None if valid is None
                               else torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert got.max() == 1.0


def test_resize_and_crop_matches_jax():
    rng = np.random.default_rng(1)
    fov = rng.uniform(size=(2, 32, 34)).astype(np.float32)
    for new_hw, crop in (((16, 17), (0, 8, 0, 16)), ((13, 40), (2, 50, 3, 9))):
        np.testing.assert_array_equal(
            resize_and_crop(torch.from_numpy(fov), new_hw, crop).numpy(),
            np.asarray(jresize(jnp.asarray(fov), new_hw, crop)))


def _loss_cfg():
    cfg = jpresets.tiny_traversability_config().to_dict()
    head = cfg["traversability_head"]["net_kwargs"]["reward_cfg"]["net_kwargs"]
    return cfg, head


@pytest.fixture(scope="module")
def objective():
    """Loss inputs at the tiny preset: the JAX synthetic batch, a random
    expected SVF and input view, and seeded reward-head weights."""
    cfg, head = _loss_cfg()
    batch = _batch(JDataset, jcollate)
    rng = np.random.default_rng(0)
    iv = np.abs(rng.normal(size=(2, 8, 16, 16))).astype(np.float32)
    exp_svf = rng.uniform(size=(2, 8, 16)).astype(np.float32)
    jm = JFCN(head)
    # seed 3 leaves about two thirds of the reward map alive after the
    # head's final relu, so that every term has a gradient
    flat = jitter_bn(seeded_variables(jm, jnp.asarray(iv), seed=3), seed=4)
    return cfg, head, batch, iv, exp_svf, jm, flat


def _jax_objective(cfg, batch, iv, exp_svf, jm, flat):
    variables = jax_variables(flat)
    mgr = JLossManager(cfg)

    def total(params):
        v = {"params": params, "batch_stats": variables["batch_stats"]}
        reward_fn = lambda x: jm.apply(v, x, False)  # noqa: E731
        td = {f"inputs/{k}": (jax.tree_util.tree_map(jnp.asarray, b)
                              if isinstance(b, dict) else jnp.asarray(b))
              for k, b in batch.items()}
        td.update({"outputs/exp_svf": jnp.asarray(exp_svf),
                   "outputs/traversability_preds": reward_fn(jnp.asarray(iv)),
                   "outputs/input_view": jnp.asarray(iv)})
        ld, meta = mgr(td, {"reward_fn": reward_fn})
        return JLossManager.total(ld), (ld, meta)

    grads, (ld, meta) = jax.grad(total, has_aux=True)(variables["params"])
    return ld, meta, grads


def _torch_objective(cfg, head, batch, iv, exp_svf, flat):
    m = load_jax_variables(MultiScaleFCN(head), flat).eval()

    def reward_fn(x):
        return m(x.permute(0, 3, 1, 2).contiguous()).permute(0, 2, 3, 1)

    tb = {k: ({kk: torch.from_numpy(vv) for kk, vv in v.items()}
              if isinstance(v, dict) else torch.from_numpy(v))
          for k, v in batch.items()}
    ivt = torch.from_numpy(iv)
    td = merge_tensor_dict(tb, {"exp_svf": torch.from_numpy(exp_svf),
                                "traversability_preds": reward_fn(ivt),
                                "input_view": ivt})
    ld, meta = LossManager(cfg)(td, {"reward_fn": reward_fn})
    LossManager.total(ld).backward()
    return ld, meta, m


@pytest.mark.parametrize("counterfactuals", [True, False])
def test_maxent_irl_loss_and_gradient_match_jax(objective, counterfactuals):
    cfg, head, batch, iv, exp_svf, jm, flat = objective
    if not counterfactuals:
        batch = {k: v for k, v in batch.items()
                 if k != "counterfactuals_label"}
    ld_j, meta_j, grads = _jax_objective(cfg, batch, iv, exp_svf, jm, flat)
    ld, meta, m = _torch_objective(cfg, head, batch, iv, exp_svf, flat)

    assert ld.keys() == ld_j.keys() and meta.keys() == meta_j.keys()
    for k, (w, v) in ld.items():
        assert w == float(ld_j[k][0])
        np.testing.assert_allclose(v.item(), float(ld_j[k][1]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    for k, v in meta.items():
        np.testing.assert_allclose(v.item(), float(meta_j[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    assert meta["MaxEntIRLLoss/reward_penalty"].item() > 0
    has_cf = meta["MaxEntIRLLoss/sum_cf_rewards"].item() != 0
    assert has_cf == counterfactuals

    flat_g = {f"params/{k}": np.asarray(v)
              for k, v in flatten_dict(grads, sep="/").items()}
    want = from_jax_variables(flat_g)
    got = dict(m.named_parameters())
    assert want.keys() == got.keys()
    for k, g in want.items():
        ref = g.numpy()
        d = np.abs(got[k].grad.numpy() - ref).max()
        assert d <= 1e-4 * max(np.abs(ref).max(), 1e-6), (k, d)
    assert any(np.abs(g.numpy()).max() > 0 for g in want.values())


def test_registry_names_unported_losses():
    # every loss of the JAX registry is ported: a name outside it raises
    with pytest.raises(KeyError, match="NoSuchLoss"):
        LossManager({"loss": [{"name": "NoSuchLoss"}]})
    assert [type(lo).__name__ for lo in LossManager(
        {"loss": [{"name": "FocalLoss"}]}).losses] == ["FocalLoss"]
    cfg, _ = _loss_cfg()
    assert [type(lo).__name__ for lo in LossManager(cfg).losses] == [
        "MaxEntIRLLoss"]
