"""The port's BEV decoder (models/blocks/resnet.py) against flax on a 32x32
grid. BN scales are jittered away from the flax init (which zeroes bn2), so
every residual branch is exercised. Tolerance: rtol 1e-4, atol 1e-4 (f32
CPU convolutions through ~20 layers, sums in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from creste_public_tpu.models.blocks import resnet as jr
from creste_public_tpu_torch.models.blocks import resnet as tr
from creste_public_tpu_torch.weights import load_jax_variables
from tests.test_torch_helpers import (
    flat_variables,
    jax_variables,
    jitter_bn,
    nchw,
    nhwc,
)


def test_basic_block_strided():
    x = np.random.default_rng(0).normal(size=(2, 9, 9, 8)).astype(np.float32)
    jm = jr.BasicBlock(16, 2)
    flat = jitter_bn(flat_variables(jm.init(
        {"params": jax.random.PRNGKey(0)}, jnp.asarray(x))))
    ref = jm.apply(jax_variables(flat), jnp.asarray(x))
    tm = load_jax_variables(tr.BasicBlock(8, 16, 2), flat).eval()
    np.testing.assert_allclose(nhwc(tm(nchw(x))), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


def test_inpainting_resnet18_multihead():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1, 32, 32, 16)).astype(np.float32)
    classes, prefixes = (8, 6, 2), ("inpainting_sam",
                                    "inpainting_sam_dynamic", "elevation")
    jm = jr.InpaintingResNet18MultiHead(classes, prefixes)
    feed = {"bev_features": jnp.asarray(x)}
    flat = jitter_bn(flat_variables(jm.init(
        {"params": jax.random.PRNGKey(0)}, feed)))
    ref = jm.apply(jax_variables(flat), feed)
    tm = load_jax_variables(
        tr.InpaintingResNet18MultiHead(16, classes, prefixes), flat).eval()
    with torch.no_grad():
        out = tm({"bev_features": torch.from_numpy(x)})
    assert sorted(out) == sorted(ref)
    for k in ref:
        assert out[k].shape == ref[k].shape, k
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
