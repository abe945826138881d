"""The port's EfficientNet-b0 + Up decoder (models/blocks/effnet.py) against
flax, at the tiny preset (stage_repeats=1), and the bilinear resize at an
odd width against jax.image.resize.

Tolerance: rtol 1e-4, atol 1e-4 on values of order 1-100 (f32 CPU
convolutions in another order through ~12 layers).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from creste_public_tpu.models.blocks import effnet as je
from creste_public_tpu_torch.config import presets
from creste_public_tpu_torch.models.blocks import effnet as te
from creste_public_tpu_torch.models.blocks.convnets import resize_bilinear
from creste_public_tpu_torch.weights import load_jax_variables
from tests.test_torch_helpers import (
    flat_variables,
    jax_variables,
    jitter_bn,
    nchw,
    nhwc,
)


def _init(jmodule, *xs):
    flat = jitter_bn(flat_variables(jmodule.init(
        {"params": jax.random.PRNGKey(0)}, *map(jnp.asarray, xs))))
    return flat, jax_variables(flat)


def test_effnet_tiny_preset():
    eff = presets.tiny_traversability_config()["vision_backbone"][
        "vision_backbone"]["effnet_cfgs"]
    h, w = eff["image_size"]
    kw = dict(in_channels=4, out_channels=int(eff["out_channels"]),
              image_size=(h, w), downsample=int(eff["downsample"]),
              stage_repeats=eff["stage_repeats"])
    x = np.random.default_rng(0).uniform(size=(2, h, w, 4)).astype(np.float32)
    x[..., 3] *= 30.0
    jm = je.EffNet(**kw)
    flat, jv = _init(jm, x)
    ref_y, ref_dec = jm.apply(jv, jnp.asarray(x), False)
    tm = load_jax_variables(te.EffNet(**kw), flat).eval()
    y, dec = tm(nchw(x))
    assert nhwc(y).shape == ref_y.shape == (2, h // 4, w // 4, 32)
    np.testing.assert_allclose(nhwc(y), np.asarray(ref_y), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(nhwc(dec), np.asarray(ref_dec), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("in_hw,out_hw", [((64, 77), (128, 153)),
                                          ((3, 5), (8, 9)), ((8, 16), (16, 32))])
def test_resize_bilinear_matches_jax(in_hw, out_hw):
    x = np.random.default_rng(1).normal(size=(2, *in_hw, 3)).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(x), (2, *out_hw, 3), "bilinear")
    got = nhwc(resize_bilinear(nchw(x), out_hw))
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_up_odd_width():
    x1 = np.random.default_rng(2).normal(size=(1, 4, 5, 6)).astype(np.float32)
    x2 = np.random.default_rng(3).normal(size=(1, 8, 9, 3)).astype(np.float32)
    jm = je.Up(7)
    flat, jv = _init(jm, x1, x2)
    ref = jm.apply(jv, jnp.asarray(x1), jnp.asarray(x2))
    tm = load_jax_variables(te.Up(9, 7), flat).eval()
    np.testing.assert_allclose(nhwc(tm(nchw(x1), nchw(x2))), np.asarray(ref),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("in_hw,k,s", [((512, 612), 3, 2), ((112, 112), 5, 2),
                                       ((15, 15), 3, 1), ((7, 9), 5, 2)])
def test_static_same_pad(in_hw, k, s):
    assert te.static_same_pad(in_hw, k, s) == je.static_same_pad(in_hw, k, s)
