"""The port's image backbone (models/depth_completion.py,
models/distillation.py, utils/depth.py) and TerrainNet against flax at the
tiny preset. Tolerance: rtol 1e-4, atol 5e-4 per module (f32 CPU
convolutions, sums in another order, on logits and features of order 30
made from a depth channel in mm); TerrainNet, whose splat and decoder
follow, 1e-3 as the whole-graph bar of docs/PARITY.md.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from creste_public_tpu.config import presets as jpresets
from creste_public_tpu.models.depth_completion import DepthCompletion as JDC
from creste_public_tpu.models.distillation import DistillationBackbone as JDB
from creste_public_tpu.models.terrainnet import TerrainNet as JTN
from creste_public_tpu.utils.depth import metric_depth_from_logits as jmd
from creste_public_tpu_torch.models.depth_completion import DepthCompletion
from creste_public_tpu_torch.models.distillation import DistillationBackbone
from creste_public_tpu_torch.models.terrainnet import TerrainNet
from creste_public_tpu_torch.utils.depth import metric_depth_from_logits
from creste_public_tpu_torch.weights import load_jax_variables
from tests.test_torch_helpers import flat_variables, jax_variables, jitter_bn


def _cfg():
    return jpresets.tiny_terrainnet_config().to_dict()


def _rgbd(B=2):
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (B, 1, 64, 80, 4)).astype(np.float32)
    x[..., 3] *= 3000.0
    return x


def _run(jmodule, tmodule, *args):
    jargs = tuple(map(jnp.asarray, args))
    flat = jitter_bn(flat_variables(
        jmodule.init({"params": jax.random.PRNGKey(0)}, *jargs)))
    ref = jmodule.apply(jax_variables(flat), *jargs)
    load_jax_variables(tmodule, flat).eval()
    with torch.no_grad():
        out = tmodule(*map(torch.from_numpy, args))
    return out, ref


def _check(out, ref, rtol, atol):
    assert sorted(out) == sorted(ref)
    for k in ref:
        assert tuple(out[k].shape) == ref[k].shape, k
        np.testing.assert_allclose(out[k].float().numpy(),
                                   np.asarray(ref[k], np.float32), rtol=rtol,
                                   atol=atol, err_msg=k)


def test_metric_depth_from_logits():
    logits = np.random.default_rng(0).normal(size=(2, 5, 6, 16)) * 4
    logits = logits.astype(np.float32)
    got = metric_depth_from_logits(torch.from_numpy(logits), "UD", 300.0,
                                   3200.0, 16)
    ref = jmd(jnp.asarray(logits), "UD", 300.0, 3200.0, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)


def test_depth_completion():
    cfg = _cfg()
    x = _rgbd()[:, 0]
    out, ref = _run(JDC(cfg), DepthCompletion(cfg), x)
    _check(out, ref, 1e-4, 5e-4)


def test_distillation_backbone():
    cfg = _cfg()
    out, ref = _run(JDB(cfg), DistillationBackbone(cfg), _rgbd())
    _check(out, ref, 1e-4, 5e-4)
    with pytest.raises(NotImplementedError):
        DistillationBackbone(dict(cfg, pe_map={"height": 4, "width": 4}))


def test_terrainnet():
    cfg = _cfg()
    p2p = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1, 1))
    p2p[:, :, :3, :3] = np.diag([0.01, 0.01, 1.0])
    out, ref = _run(JTN(cfg), TerrainNet(cfg), _rgbd(), p2p)
    _check(out, ref, 1e-3, 1e-3)
    with pytest.raises(NotImplementedError):
        TerrainNet(dict(cfg, use_temporal=True))
