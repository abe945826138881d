"""Two options the port once refused, held to the JAX package on the CPU.

* ``ConvLayer(use_norm=True, norm_type="group_norm")``: flax's
  ``nn.GroupNorm(num_groups=2)`` (epsilon 1e-6) after the conv
  (``creste_public_tpu/models/blocks/convnets.py:158-159``); any other
  norm type raises ``ValueError`` with JAX's message.
* ``ConvGRU`` with an even kernel: flax's ``padding="SAME"`` pads an even
  kernel ``(k-1)//2`` before and ``k//2`` after
  (``creste_public_tpu/models/blocks/convgru.py:71, 82``).

The same seeded weights and inputs go through both packages. The forward
meets JAX's to FWD_RTOL in f32, and the gradient of a seeded linear
functional of the output, in every parameter and in the input, meets
JAX's to GRAD_RTOL per tensor in f64 (JAX under x64 with f64 weights).
"""
from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from creste_public_tpu.models.blocks.convgru import ConvGRU as JConvGRU
from creste_public_tpu.models.blocks.convnets import ConvLayer as JConvLayer
from creste_public_tpu_torch.models.blocks.convgru import ConvGRU
from creste_public_tpu_torch.models.blocks.convnets import (
    ConvLayer,
    same_padding,
)
from creste_public_tpu_torch.weights import from_jax_variables
from tests.test_torch_helpers import seeded_variables

FWD_RTOL = 1e-5
GRAD_RTOL = 1e-5


@contextlib.contextmanager
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def rel(got, want) -> float:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def jitter(flat: dict, seed: int) -> dict:
    """Biases, GroupNorm scales and shifts off their init, so that each
    carries a gradient of its own."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in flat.items():
        leaf = k.rsplit("/", 1)[-1]
        if leaf == "bias":
            v = v + 0.2 * rng.normal(size=v.shape)
        elif leaf == "scale":
            v = 1.0 + 0.3 * rng.normal(size=v.shape)
        out[k] = np.asarray(v, np.float32)
    return out


def unflatten(flat: dict) -> dict:
    tree: dict = {}
    for k, v in flat.items():
        node = tree
        *path, leaf = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def check_parity(japply, tmodel, tforward, flat, x, cot):
    """``japply(variables, x)`` and ``tforward(tmodel, x_tensor)`` give the
    output, both NHWC. The forward in f32, then the gradient of
    ``<output, cot>`` in f64 in every parameter and in the input. (The f64
    flax gradient passes through ``from_jax_variables`` for its layout,
    which rounds it to f32: 6e-8 of each entry, far under GRAD_RTOL.)"""
    tmodel.load_state_dict(from_jax_variables(flat), strict=True)
    want = japply(unflatten({k: jnp.asarray(v) for k, v in flat.items()}),
                  jnp.asarray(x))
    with torch.no_grad():
        got = tforward(tmodel, torch.from_numpy(x))
    assert rel(got, want) <= FWD_RTOL

    with x64():
        def loss(v, xj):
            return jnp.sum(japply(v, xj) * jnp.asarray(cot, jnp.float64))

        v64 = unflatten({k: jnp.asarray(a, jnp.float64)
                         for k, a in flat.items()})
        gv, gx = jax.grad(loss, argnums=(0, 1))(
            v64, jnp.asarray(x, jnp.float64))
        gx = np.asarray(gx)
        want_g = from_jax_variables(flatten_dict(gv, sep="/"))
    tmodel.double()
    xt = torch.from_numpy(x).double().requires_grad_(True)
    (tforward(tmodel, xt) * torch.from_numpy(cot)).sum().backward()
    assert rel(xt.grad, gx) <= GRAD_RTOL
    named = dict(tmodel.named_parameters())
    assert set(want_g) == set(named)
    for k, g in want_g.items():
        assert rel(named[k].grad, g.numpy()) <= GRAD_RTOL, k


@pytest.mark.parametrize("stride,use_bias", [(1, False), (2, True)])
def test_group_norm_conv_layer_matches_jax(stride, use_bias):
    B, H, W, C, F = 2, 9, 11, 6, 8
    jm = JConvLayer(F, 3, stride, use_norm=True, norm_type="group_norm",
                    use_bias=use_bias)
    rng = np.random.default_rng(stride)
    x = rng.normal(size=(B, H, W, C)).astype(np.float32)
    flat = jitter(seeded_variables(jm, jnp.asarray(x), seed=stride), 3)
    assert "params/GroupNorm_0/scale" in flat
    Ho, Wo = -(-H // stride), -(-W // stride)
    cot = rng.normal(size=(B, Ho, Wo, F))
    model = ConvLayer(C, F, 3, stride, use_norm=True,
                      norm_type="group_norm", use_bias=use_bias)
    check_parity(jm.apply, model,
                 lambda m, xt: m(xt.permute(0, 3, 1, 2)).permute(0, 2, 3, 1),
                 flat, x, cot)


def test_unknown_norm_type_raises_like_jax():
    x = jnp.zeros((1, 4, 4, 2))
    with pytest.raises(ValueError, match="Unknown norm type: layer_norm"):
        JConvLayer(4, use_norm=True, norm_type="layer_norm").init(
            jax.random.PRNGKey(0), x)
    with pytest.raises(ValueError, match="Unknown norm type: layer_norm"):
        ConvLayer(2, 4, use_norm=True, norm_type="layer_norm")


@pytest.mark.parametrize("size,kernel,stride", [
    (10, 2, 1), (10, 3, 1), (10, 4, 1), (9, 3, 2), (10, 3, 2), (7, 1, 2)])
def test_same_padding_equals_lax(size, kernel, stride):
    """The split ``same_padding`` gives is lax's own."""
    from jax import lax

    pads = lax.padtype_to_pads((size,), (kernel,), (stride,), "SAME")
    assert same_padding(size, kernel, stride) == tuple(pads[0])


@pytest.mark.parametrize("kernel", [(2, 2), (2, 3), (4, 4)])
def test_even_kernel_convgru_matches_jax(kernel):
    B, T, H, W, C = 2, 2, 7, 8, 3
    hidden = [5, 4]
    jm = JConvGRU(hidden_dims=hidden, kernel=kernel)
    rng = np.random.default_rng(sum(kernel))
    x = rng.normal(0, 0.5, (B, T, H, W, C)).astype(np.float32)
    flat = jitter(seeded_variables(jm, jnp.asarray(x), seed=sum(kernel)), 4)
    cot = rng.normal(size=(B, T, H, W, hidden[-1]))
    check_parity(lambda v, xj: jm.apply(v, xj)[0], ConvGRU(C, hidden, kernel),
                 lambda m, xt: m(xt)[0], flat, x, cot)
