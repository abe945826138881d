"""The port's preprocessing ops (``ops/depth_projection.py``,
``ops/infill.py``, ``ops/elevation.py``) and ``utils/concurrency.py``
against the JAX package's on the same seeded NumPy inputs, on the CPU.

Bars: the depth z-buffer and every elevation map (min/max, variance,
lower/upper, counts, classes) exact: the projection runs XLA's fused
multiply-add chains and the inverse of the reference pose is the LAPACK
LU solve JAX's is, so a pixel that truncation moves would show as a
mismatch (their count is printed and must be 0), and the variances round
as XLA's fused expressions do. The IDW infill to 1e-5 of the map's largest
value (its 81 weighted sums are fused otherwise).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from creste_public_tpu.ops import depth_projection as jdp
from creste_public_tpu.ops import elevation as jel
from creste_public_tpu.ops import infill as jinf
from creste_public_tpu.utils.concurrency import parallel_map as jparallel_map
from creste_public_tpu_torch.ops import depth_projection as dp
from creste_public_tpu_torch.ops import elevation as el
from creste_public_tpu_torch.ops import infill as inf
from creste_public_tpu_torch.utils.concurrency import parallel_map
from tests.test_torch_step_helpers import one_torch_thread  # noqa: F401

H, W = 48, 64
RTOL = 1e-5


def t(x):
    return torch.from_numpy(np.array(x))


def camera() -> np.ndarray:
    """The raw synthetic tree's lidar2camrect [4, 4] at H x W."""
    fx = 0.9 * W
    K = np.array([[fx, 0, W / 2, 0], [0, fx, H / 2, 0], [0, 0, 1, 0]])
    l2c = np.array([[0, -1, 0, 0], [0, 0, -1, 0.3], [1, 0, 0, 0],
                    [0, 0, 0, 1.0]])
    return np.vstack([K @ l2c, [0, 0, 0, 1]]).astype(np.float32)


def scene(seed: int = 0, n: int = 20000):
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(0.5, 8, n), rng.uniform(-4, 4, n),
                    rng.uniform(-1, 1, n)], -1).astype(np.float32)
    S = 5
    yaw = rng.uniform(-0.4, 0.4, S)
    poses = np.tile(np.eye(4), (S, 1, 1))
    poses[:, 0, 0], poses[:, 0, 1] = np.cos(yaw), -np.sin(yaw)
    poses[:, 1, 0], poses[:, 1, 1] = np.sin(yaw), np.cos(yaw)
    poses[:, :3, 3] = rng.normal(size=(S, 3)) * [20, 20, 0.5]
    return pts, pts[: S * (n // S)].reshape(S, n // S, 3), poses


def moved(a: np.ndarray, b: np.ndarray) -> int:
    """Pixels whose depth differs."""
    return int((a != b).sum())


@pytest.mark.parametrize("reduce", ["max", "min"])
def test_points_to_depth_matches_jax(reduce):
    pts, _, _ = scene()
    want = np.asarray(jdp.points_to_depth(jnp.asarray(pts),
                                          jnp.asarray(camera()), (H, W),
                                          reduce))
    got = dp.points_to_depth(t(pts), t(camera()), (H, W), reduce).numpy()
    assert (want > 0).sum() > 500
    print(f"{reduce}: {moved(want, got)} pixels moved")
    assert moved(want, got) == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_accumulate_and_project_matches_jax(seed):
    """The pose chain (ref_from_scan in f32) and the fused op."""
    _, scans, poses = scene(seed)
    ref = poses[2]
    want = np.asarray(jdp.accumulate_scans(
        jnp.asarray(scans), jnp.asarray(poses), jnp.asarray(ref)))
    got = dp.accumulate_scans(t(scans), poses, ref).numpy()
    np.testing.assert_array_equal(got, want)
    want = np.asarray(jdp.accumulate_and_project(
        jnp.asarray(scans), jnp.asarray(poses), jnp.asarray(ref),
        jnp.asarray(camera()), (H, W)))
    got = dp.accumulate_and_project(t(scans), poses, ref, t(camera()),
                                    (H, W)).numpy()
    print(f"seed {seed}: {moved(want, got)} pixels moved")
    assert moved(want, got) == 0


def test_projection_basics():
    """Two points on one ray land on one pixel: max keeps the farther, min
    the nearer; a point behind the camera is dropped."""
    pts = np.array([[5.0, 1.0, 0.8], [10.0, 2.0, 1.3], [-5.0, 0, 0]],
                   np.float32)
    d_max = dp.points_to_depth(t(pts), t(camera()), (H, W)).numpy()
    d_min = dp.points_to_depth(t(pts), t(camera()), (H, W), "min").numpy()
    assert (d_max > 0).sum() == (d_min > 0).sum() == 1
    assert d_max.max() == 10.0 and d_min.max() == 5.0
    assert np.argmax(d_max) == np.argmax(d_min)


def test_idw_grid_form_matches_jax():
    _, scans, poses = scene()
    depth = np.asarray(jdp.accumulate_and_project(
        jnp.asarray(scans), jnp.asarray(poses), jnp.asarray(poses[2]),
        jnp.asarray(camera()), (H, W)))
    want = np.asarray(jinf.idw_densify(None, depth=jnp.asarray(depth),
                                       window=4))
    got = inf.idw_densify(depth=t(depth), window=4).numpy()
    assert (want > 0).sum() > 0.5 * want.size
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * want.max())


@pytest.mark.parametrize("window", [2, 3])
def test_idw_point_form_matches_jax(window):
    """Subpixel samples, some outside the image, some on one pixel (the
    last one wins)."""
    rng = np.random.default_rng(3)
    uvd = np.stack([rng.uniform(-1, W + 1, 600), rng.uniform(-1, H + 1, 600),
                    rng.uniform(0, 5, 600)], -1).astype(np.float32)
    uvd[300:310, :2] = uvd[0, :2] + 0.01
    want = np.asarray(jinf.idw_densify(jnp.asarray(uvd), img_hw=(H, W),
                                       window=window))
    got = inf.idw_densify(t(uvd), img_hw=(H, W), window=window).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * want.max())


def elevation_points(seed: int = 0, n: int = 5000) -> np.ndarray:
    """Ground points near z=0 and overhangs above, some outside the map."""
    rng = np.random.default_rng(seed)
    z = np.where(rng.uniform(size=n) < 0.25, rng.uniform(0.5, 2.5, n),
                 rng.uniform(-0.1, 0.3, n))
    return np.stack([rng.uniform(-1.7, 1.7, n), rng.uniform(-1.7, 1.7, n),
                     z], -1).astype(np.float32)


def test_bin_min_max_var_matches_jax():
    p = elevation_points()
    rng = np.random.default_rng(1)
    cell = rng.integers(0, 64, len(p))
    valid = rng.uniform(size=len(p)) > 0.1
    want = jel.bin_min_max_var(jnp.asarray(p[:, 2]), jnp.asarray(cell),
                               jnp.asarray(valid), 80)
    got = el.bin_min_max_var(t(p[:, 2]), t(cell), t(valid), 80)
    for i, name in enumerate(("min", "max", "var", "count")):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]),
                                      err_msg=name)


@pytest.mark.parametrize("seed", [0, 1])
def test_lower_upper_elevation_matches_jax(seed):
    """The gap scan over cells with ground, overhangs, a first point above
    the gate and cells without ground."""
    p = elevation_points(seed)
    rng = np.random.default_rng(seed + 5)
    cell = rng.integers(0, 40, len(p))
    valid = rng.uniform(size=len(p)) > 0.05
    ground = rng.uniform(-0.1, 0.1, 40).astype(np.float32)
    ground[::7] = np.nan
    ground[3] = -1.0  # every point of cell 3 starts above the gate
    args = (p[:, 2], cell, valid, ground)
    want = jel.lower_upper_elevation(*map(jnp.asarray, args), 40)
    got = el.lower_upper_elevation(*map(t, args), 40)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    classes = np.asarray(want[2])
    assert {el.PROJ_GROUND, el.PROJ_CEILING, el.PROJ_SKY} <= set(classes)


def test_gap_scan_cases():
    """The JAX tests' three hand cases: an overhang, none, and a first
    point above the gate."""
    z = t(np.array([0.0, 0.1, 0.2, 1.8, 1.9, 5.0], np.float32))
    lower, upper, cls = el.lower_upper_elevation(
        z, torch.zeros(6, dtype=torch.long), torch.ones(6, dtype=torch.bool),
        torch.zeros(1), 1, gap_thres=0.5)
    assert abs(float(lower[0]) - 0.2) < 1e-6
    assert abs(float(upper[0]) - 1.8) < 1e-6
    assert cls.tolist() == [el.PROJ_GROUND] * 3 + [
        el.PROJ_SKY, el.PROJ_CEILING, el.PROJ_SKY]
    lower, upper, _ = el.lower_upper_elevation(
        t(np.array([1.5, 1.6], np.float32)), torch.zeros(2, dtype=torch.long),
        torch.ones(2, dtype=torch.bool), torch.zeros(1), 1)
    assert np.isnan(float(lower[0]))


def test_elevation_maps_from_points_matches_jax():
    p = elevation_points()
    want = jel.elevation_maps_from_points(jnp.asarray(p), (32, 32), 1.6)
    got = el.elevation_maps_from_points(t(p), (32, 32), 1.6)
    assert want.keys() == got.keys()
    for k, w in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(w),
                                      err_msg=k)
    assert np.isfinite(np.asarray(want["lower"])).sum() > 100


@pytest.mark.parametrize("nlowest", [None, 3, 4])
def test_reference_elevation_maps_matches_jax(nlowest):
    """The shipped Map2D labels: the plain per-cell min (the shipped
    default) and the robust lower median, ignored classes dropped."""
    p = elevation_points(2)
    labels = np.random.default_rng(4).integers(0, 3, len(p))
    want = jel.reference_elevation_maps(
        jnp.asarray(p), jnp.asarray(labels), (32, 32), 3.2, 3.2,
        nlowest=nlowest)
    got = el.reference_elevation_maps(t(p), t(labels), (32, 32), 3.2, 3.2,
                                      nlowest=nlowest)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert np.isfinite(np.asarray(want[0])).sum() > 100


def _sq(x):
    return x * x


@pytest.mark.parametrize("workers, mode", [(1, "thread"), (4, "thread"),
                                           (2, "process")])
def test_parallel_map_matches_jax(workers, mode):
    items = range(17)
    fn = abs if mode == "process" else _sq
    assert parallel_map(fn, items, workers, mode) == jparallel_map(
        fn, items, workers, mode)
    with pytest.raises(ValueError):
        parallel_map(_sq, items, 2, "fork")
