"""The port's conv stacks (models/blocks/convnets.py) against flax.

Same weights (a flax init with jittered BNs, carried over by
from_jax_variables), same seeded numpy inputs. Tolerance: rtol 1e-4,
atol 1e-4 (f32 convolutions on the CPU, sums in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from creste_public_tpu.config import presets as jpresets
from creste_public_tpu.models.blocks import convnets as jc
from creste_public_tpu_torch.config import presets
from creste_public_tpu_torch.models.blocks import convnets as tc
from creste_public_tpu_torch.weights import load_jax_variables
from tests.test_torch_helpers import (
    flat_variables,
    jax_variables,
    jitter_bn,
    nchw,
    nhwc,
)

RTOL, ATOL = 1e-4, 1e-4


def _pair(jmodule, tmodule, x_nhwc, **apply_kw):
    flat = jitter_bn(flat_variables(jmodule.init(
        {"params": jax.random.PRNGKey(0)}, jnp.asarray(x_nhwc), **apply_kw)))
    ref = np.asarray(jmodule.apply(jax_variables(flat), jnp.asarray(x_nhwc),
                                   **apply_kw))
    load_jax_variables(tmodule, flat).eval()
    return ref


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("cfg", [
    {"kernels": [3], "paddings": [1], "dims": [8, 5],
     "norm_type": "batch_norm"},
    {"kernels": [1, 1, 1], "paddings": [0, 0, 0], "dims": [8, 12, 12, 6],
     "norm_type": "batch_norm"},
    {"kernels": [3, 1], "paddings": [1, 0], "dims": [8, 6, 4],
     "stride": [2, 1]},
])
def test_multilayerconv(cfg):
    x = _x((2, 9, 11, 8))
    tm = tc.MultiLayerConv(cfg)
    ref = _pair(jc.MultiLayerConv(cfg), tm, x, train=False)
    np.testing.assert_allclose(nhwc(tm(nchw(x))), ref, rtol=RTOL, atol=ATOL)


def test_convencoder():
    cfg = {"kernels": [1], "paddings": [0], "dims": [10, 7],
           "norm_type": "batch_norm"}
    x = _x((3, 6, 7, 10))
    tm = tc.ConvEncoder(cfg)
    ref = _pair(jc.ConvEncoder(cfg), tm, x, train=False)
    np.testing.assert_allclose(nhwc(tm(nchw(x))), ref, rtol=RTOL, atol=ATOL)


def test_mlp():
    x = _x((2, 4, 5, 1))
    tm = tc.MLP(1, (16, 8))
    ref = _pair(jc.MLP((16, 8)), tm, x)
    np.testing.assert_allclose(tm(torch.from_numpy(x)).detach().numpy(), ref,
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape", [(1, 64, 128, 40), (2, 12, 18, 40)])
def test_multiscale_fcn_unfused(shape):
    cfg = presets.traversability_model_config()["traversability_head"][
        "net_kwargs"]["reward_cfg"]["net_kwargs"]
    x = _x(shape)
    tm = tc.MultiScaleFCN(cfg)
    ref = _pair(jc.MultiScaleFCN(cfg), tm, x, train=False)
    np.testing.assert_allclose(nhwc(tm(nchw(x))), ref, rtol=RTOL, atol=ATOL)


def test_batch_norm_eval_form():
    """Eval BN == (x - mean) / sqrt(var + eps) * scale + bias, with the
    EfficientNet eps 1e-3 as well as the default 1e-5."""
    for eps in (1e-5, 1e-3):
        bn = tc.BatchNorm(3, eps).eval()
        with torch.no_grad():
            bn.weight.copy_(torch.tensor([1.5, -0.5, 2.0]))
            bn.bias.copy_(torch.tensor([0.1, 0.2, -0.3]))
            bn.running_mean.copy_(torch.tensor([0.3, -1.0, 2.0]))
            bn.running_var.copy_(torch.tensor([0.01, 4.0, 0.5]))
        x = torch.from_numpy(_x((2, 3, 4, 5)))
        want = ((x - bn.running_mean[:, None, None])
                / torch.sqrt(bn.running_var[:, None, None] + eps)
                * bn.weight[:, None, None] + bn.bias[:, None, None])
        torch.testing.assert_close(bn(x), want)


def test_presets_equal_jax_presets():
    """The port's plain-dict presets equal the JAX package's."""
    for name in ("terrainnet_model_config", "traversability_model_config",
                 "tiny_terrainnet_config", "tiny_traversability_config"):
        assert getattr(presets, name)().to_dict() == \
            getattr(jpresets, name)().to_dict(), name
