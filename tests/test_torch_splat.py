"""The port's BEV lift (ops/splat.py, models/blocks/splat.py,
utils/geometry.py) against the JAX package.

Tolerances: the splat 1e-5 (f32 scatter sums in another order); the
Camera2MapMulti module 1e-4. The in-range mask is discontinuous, so the
inputs keep every point well away from the range boundary: a point within
float rounding of a boundary is drawn with probability ~1e-6 per point.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from creste_public_tpu.config import presets as jpresets
from creste_public_tpu.models.blocks.splat import Camera2MapMulti as JC2M
from creste_public_tpu.ops import splat as js
from creste_public_tpu.utils import geometry as jg
from creste_public_tpu_torch.models.blocks.splat import Camera2MapMulti
from creste_public_tpu_torch.ops import splat as ts
from creste_public_tpu_torch.utils import geometry as tg
from creste_public_tpu_torch.weights import load_jax_variables
from tests.test_torch_helpers import flat_variables, jax_variables, jitter_bn


@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("mode", ["mean", "sum", "max"])
def test_splat_bilinear(B, mode):
    rng = np.random.default_rng(B)
    H, W, P, F = 12, 10, 300, 5
    # coords from -1.5 to W+0.5 / H+0.5: corners fall off every grid edge
    xy = np.stack([rng.uniform(-1.5, W + 0.5, (B, P)),
                   rng.uniform(-1.5, H + 0.5, (B, P))], -1).astype(np.float32)
    feats = rng.normal(size=(B, P, F)).astype(np.float32)
    ref_f, ref_d = js.splat_bilinear(jnp.asarray(xy), jnp.asarray(feats),
                                     (H, W), mode)
    f, d = ts.splat_bilinear(torch.from_numpy(xy), torch.from_numpy(feats),
                             (H, W), mode)
    np.testing.assert_allclose(f.numpy(), np.asarray(ref_f), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(d.numpy(), np.asarray(ref_d), rtol=1e-5,
                               atol=1e-5)
    bev, dens = ts.splat_to_bev(torch.from_numpy(xy), torch.from_numpy(feats),
                                (H, W), mode)
    assert bev.shape == (B, H, W, F) and dens.shape == (B, H, W, 1)


def test_splat_rejects_unknown_mode():
    with pytest.raises(ValueError):
        ts.splat_bilinear(torch.zeros(1, 2, 2), torch.zeros(1, 2, 3), (4, 4),
                          "median")


def _pinhole_p2p(h, w, B=1):
    fx = fy = 0.9 * w
    kinv = np.array([[1 / fx, 0, -w / 2 / fx], [0, 1 / fy, -h / 2 / fy],
                     [0, 0, 1.0]])
    rot = np.array([[0, 0, 1.0], [-1, 0, 0], [0, -1, 0]])
    p2p = np.eye(4, dtype=np.float32)
    p2p[:3, :3] = (rot @ kinv).astype(np.float32)
    return np.tile(p2p, (B, 1, 1, 1))


def test_geometry():
    rng = np.random.default_rng(0)
    depth = rng.uniform(0.5, 3.0, (2, 1, 6, 7)).astype(np.float32)
    p2p = _pinhole_p2p(6, 7, 2)
    ref = np.asarray(jg.backproject_depth(jnp.asarray(depth),
                                          jnp.asarray(p2p)))
    xyz = tg.backproject_depth(torch.from_numpy(depth), torch.from_numpy(p2p))
    np.testing.assert_allclose(xyz.numpy(), ref, rtol=1e-6, atol=1e-6)

    lo = np.array([-1.6, -1.6, -2.0], np.float32)
    hi = np.array([1.6, 1.6, 1.0], np.float32)
    l2m = tg.lidar_to_map_matrix(lo)
    np.testing.assert_array_equal(l2m, jg.lidar_to_map_matrix(lo))
    vox = np.array([0.1, 0.1], np.float32)
    np.testing.assert_allclose(
        tg.points_to_voxels(xyz, torch.from_numpy(l2m),
                            torch.from_numpy(vox)).numpy(),
        np.asarray(jg.points_to_voxels(jnp.asarray(ref), jnp.asarray(l2m),
                                       jnp.asarray(vox))),
        rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(
        tg.point_in_range_mask(xyz, torch.from_numpy(lo),
                               torch.from_numpy(hi)).numpy(),
        np.asarray(jg.point_in_range_mask(jnp.asarray(ref), lo, hi)))
    np.testing.assert_array_equal(
        tg.create_trapezoidal_fov_mask(64, 128, 70, 70, 0, 100),
        jg.create_trapezoidal_fov_mask(64, 128, 70, 70, 0, 100))


@pytest.mark.parametrize("B", [1, 2])
def test_camera2map_multi(B):
    cfg = jpresets.tiny_terrainnet_config()["camera_projector"].to_dict()
    rng = np.random.default_rng(B)
    H, W, F = 16, 20, 32
    depth = rng.uniform(0.3, 3.0, (B, 1, H, W)).astype(np.float32)
    feats = rng.normal(size=(B, 1, H, W, F)).astype(np.float32)
    p2p = _pinhole_p2p(64, 80, B)
    jm = JC2M(cfg, scatter_mode="mean")
    args = tuple(map(jnp.asarray, (depth, feats, p2p)))
    flat = jitter_bn(flat_variables(
        jm.init({"params": jax.random.PRNGKey(0)}, *args)))
    ref = jm.apply(jax_variables(flat), *args)
    tm = load_jax_variables(Camera2MapMulti(cfg), flat).eval()
    with torch.no_grad():
        out = tm(*map(torch.from_numpy, (depth, feats, p2p)))
    assert float(ref["bev_densities"].sum()) > 0  # points land in range
    for k in ("bev_features", "bev_densities", "bev_coords"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
