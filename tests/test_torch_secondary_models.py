"""The secondary models against the JAX package's, in eval mode, f32.

``CnnMLP``, ``VisionTransformer`` (at a patch grid that downsamples the
position grid, and one that upsamples it), ``FoundationBackbone`` (a
downsampling input resize), ``gwc_volume`` and ``MSNet2D``, at the JAX
tests' tiny configs (``tests/test_secondary_models.py``), with seeded
weights (BatchNorm statistics jittered) carried across by
``weights.from_jax_variables``: every output meets JAX's to RTOL relative
to its largest entry, the bins exactly where the logits' top two are
apart. The resize both use meets ``jax.image.resize(..., "bilinear")`` to
RESIZE_RTOL at scales 0.3 to 2.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from creste_public_tpu.models.blocks.cnnmlp import CnnMLP as JCnnMLP
from creste_public_tpu.models.blocks.vit import VisionTransformer as JViT
from creste_public_tpu.models.foundation import (
    FoundationBackbone as JFoundation,
)
from creste_public_tpu.models.stereodepth import MSNet2D as JMSNet2D
from creste_public_tpu.models.stereodepth import gwc_volume as jgwc_volume
from creste_public_tpu_torch.models.blocks.cnnmlp import CnnMLP
from creste_public_tpu_torch.models.blocks.convnets import (
    resize_bilinear_antialiased,
)
from creste_public_tpu_torch.models.blocks.vit import VisionTransformer
from creste_public_tpu_torch.models.foundation import FoundationBackbone
from creste_public_tpu_torch.models.stereodepth import MSNet2D, gwc_volume
from creste_public_tpu_torch.weights import from_jax_variables
from tests.test_torch_helpers import jax_variables, jitter_bn, seeded_variables
from tests.test_torch_step_helpers import one_torch_thread  # noqa: F401

RTOL = 1e-5
RESIZE_RTOL = 1e-6

TINY_VIT = {"embed_dim": 32, "depth": 2, "num_heads": 2, "patch_size": 14,
            "pos_grid": 8}
FOUNDATION = {
    "vision_backbone": {"backbone_cfgs": {
        "input_shape": [56, 70], "output_shape": [16, 20], "vit": TINY_VIT}},
    "depth_head": {"dims": [32, 16], "kernels": [3], "paddings": [1],
                   "norm_type": "batch_norm"},
    "discretize": {"mode": "UD", "num_bins": 16, "depth_min": 300,
                   "depth_max": 3200},
}
MSNET = {
    "cams": 2,
    "vision_backbone": {
        "class_name": "DepthCompletion", "name": "efficientnet-b0",
        "input_type": "rgb", "return_feats": True,
        "effnet_cfgs": {"in_channels": 3, "out_channels": 32,
                        "downsample": 4, "image_size": [64, 80]}},
    "costvolume_trunk": {"squeeze_dim": 16, "num_groups": 1,
                         "volume_size": 8, "hg_size": 8},
    "depth_head": {"dims": [8, 16], "kernels": [3], "paddings": [1],
                   "norm_type": "batch_norm"},
    "discretize": {"mode": "UD", "num_bins": 16, "depth_min": 300,
                   "depth_max": 3200},
}
CNNMLP = {
    "input_keys": ["a", "b"],
    "cnn_cfg": {"net_kwargs": {"dims": [6, 8], "kernels": [3],
                               "paddings": [1], "strides": [2],
                               "norm_type": "batch_norm"}},
    "mlp_cfg": {"net_kwargs": {"dims": [8 * 4 * 4, 16, 8]}},
}


def rel(got: torch.Tensor, want) -> float:
    got = got.detach().numpy().astype(np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def carried(jmodel, *args, seed: int = 0):
    """Seeded flax-shaped weights with jittered BNs: the JAX variables and
    the port's state_dict."""
    flat = jitter_bn(seeded_variables(jmodel, *args, seed=seed), seed + 1)
    rng = np.random.default_rng(seed + 2)
    # the init leaves these at 0 or constants: give each a real value
    flat = {k: (0.02 * rng.normal(size=v.shape).astype(np.float32)
                if k.rsplit("/", 1)[-1] in ("cls_token", "pos_embed",
                                             "ls1", "ls2", "bias")
                and "BatchNorm" not in k and "_bn" not in k else v)
            for k, v in flat.items()}
    return jax_variables(flat), from_jax_variables(flat)


def check_outputs(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k in want:
        if k.endswith("_bins"):
            logits = np.sort(np.asarray(want["depth_preds_logits"]), -1)
            clear = (logits[..., -1] - logits[..., -2]) > 1e-4
            assert np.array_equal(got[k].numpy()[clear],
                                  np.asarray(want[k])[clear]), k
            continue
        assert rel(got[k], want[k]) <= RTOL, (k, rel(got[k], want[k]))


@pytest.mark.parametrize("scale", [0.3, 0.5, 0.97, 1.5, 2.0])
def test_resize_equals_jax_image_resize(scale):
    x = np.random.default_rng(int(scale * 10)).normal(
        size=(2, 37, 41, 3)).astype(np.float32)
    out = (max(1, round(37 * scale)), max(1, round(41 * scale)))
    want = jax.image.resize(jnp.asarray(x), (2, *out, 3), "bilinear")
    got = resize_bilinear_antialiased(
        torch.from_numpy(x).permute(0, 3, 1, 2), out).permute(0, 2, 3, 1)
    assert rel(got, want) <= RESIZE_RTOL


@pytest.mark.parametrize("pos_grid,hw", [(8, (56, 70)), (3, (60, 75))])
def test_vit_matches_jax(pos_grid, hw):
    cfg = dict(TINY_VIT, pos_grid=pos_grid)
    x = np.random.default_rng(1).normal(size=(2, *hw, 3)).astype(np.float32)
    jm = JViT(cfg)
    jv, sd = carried(jm, jnp.asarray(x))
    model = VisionTransformer(cfg)
    model.load_state_dict(sd, strict=True)
    want = jax.jit(jm.apply)(jv, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.shape == (2, hw[0] // 14, hw[1] // 14, 32)
    assert rel(got, want) <= RTOL


def test_foundation_backbone_matches_jax():
    x = np.random.default_rng(2).uniform(size=(1, 2, 64, 80, 4)).astype(
        np.float32)
    jm = JFoundation(FOUNDATION)
    jv, sd = carried(jm, jnp.asarray(x))
    model = FoundationBackbone(FOUNDATION).eval()
    model.load_state_dict(sd, strict=True)
    want = jax.jit(jm.apply)(jv, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got["depth_preds_logits"].shape == (2, 16, 20, 16)
    check_outputs(got, want)


def test_gwc_volume_matches_jax():
    rng = np.random.default_rng(3)
    left, right = (rng.normal(size=(2, 5, 16, 8)).astype(np.float32)
                   for _ in range(2))
    for disp, groups in ((4, 1), (6, 4)):
        want = jgwc_volume(jnp.asarray(left), jnp.asarray(right), disp,
                           groups)
        got = gwc_volume(torch.from_numpy(left), torch.from_numpy(right),
                         disp, groups)
        assert rel(got, want) <= RTOL


def test_msnet2d_matches_jax():
    x = np.random.default_rng(4).uniform(size=(2, 2, 64, 80, 3)).astype(
        np.float32)
    jm = JMSNet2D(MSNET)
    jv, sd = carried(jm, jnp.asarray(x))
    model = MSNet2D(MSNET).eval()
    model.load_state_dict(sd, strict=True)
    want = jax.jit(jm.apply)(jv, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got["depth_preds_logits"].shape == (2, 16, 20, 16)
    check_outputs(got, want)


def test_cnnmlp_matches_jax():
    rng = np.random.default_rng(5)
    inputs = {"a": rng.normal(size=(2, 8, 8, 2)).astype(np.float32),
              "b": rng.normal(size=(2, 8, 8, 4)).astype(np.float32)}
    jm = JCnnMLP(CNNMLP)
    jin = {k: jnp.asarray(v) for k, v in inputs.items()}
    jv, sd = carried(jm, jin)
    # flax infers the first layer's width (8 x 8 x 8), not dims[0]
    assert sd["mlp.fc_0.weight"].shape == (16, 512)
    model = CnnMLP(CNNMLP).eval()
    model.load_state_dict(sd, strict=True)
    want = jm.apply(jv, jin)
    with torch.no_grad():
        got = model({k: torch.from_numpy(v) for k, v in inputs.items()})
    assert rel(got, want) <= RTOL
