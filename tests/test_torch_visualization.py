"""The port's ``utils/visualization.py`` against the JAX package's.

* Each colormap table of ``utils/colormaps.py`` equals matplotlib's map
  converted as the JAX package's ``_colormap`` converts it (tests may
  import matplotlib; the port may not).
* Each function of the module gives the JAX function's output exactly, on
  seeded inputs (uint8 images, and the files ``numpy_to_pcd``,
  ``save_png`` and ``save_depth_color_image`` write).
* ``visualize_elevation_3d`` draws with PIL where JAX draws a matplotlib
  surface, so its pixels differ; held here: JAX's shape and dtype, a flat
  map drawn only in turbo's lowest colour on the white background, a
  raised square drawn in higher turbo colours than its surround, and
  raising the square moving its pixels up the image.
"""
from __future__ import annotations

import os

import matplotlib
import numpy as np
import pytest

from creste_public_tpu.utils import visualization as jvz
from creste_public_tpu_torch.utils import visualization as vz
from creste_public_tpu_torch.utils.colormaps import COLORMAPS

R = np.random.default_rng


@pytest.mark.parametrize("name", sorted(COLORMAPS))
def test_colormap_tables_equal_matplotlib(name):
    n = len(COLORMAPS[name])
    want = (matplotlib.colormaps[name](np.linspace(0, 1, n))[:, :3]
            * 255).astype(np.uint8)
    assert n == (20 if name == "tab20" else 256)
    assert COLORMAPS[name].dtype == np.uint8
    assert np.array_equal(COLORMAPS[name], want)
    assert np.array_equal(vz._colormap(name, n), jvz._colormap(name, n))


def _rgb(seed, h=24, w=30):
    return R(seed).uniform(0, 1, (h, w, 3)).astype(np.float32)


def _depth(seed, h=24, w=30):
    d = R(seed).uniform(0, 30, (h, w)).astype(np.float32)
    d[R(seed + 1).uniform(size=(h, w)) < 0.3] = 0
    return d


def _policy(seed):
    p = R(seed).uniform(size=(16, 20, 8)).astype(np.float32)
    return p / p.sum(-1, keepdims=True)


def _rgbd3d(seed):
    rgbd = np.concatenate([R(seed).uniform(0, 1, (4, 3, 12, 16)),
                           R(seed + 1).uniform(500, 8000, (4, 1, 12, 16))], 1)
    rgbd[:, 3][R(seed + 2).uniform(size=(4, 12, 16)) < 0.2] = 0
    p2p = np.tile(np.eye(4, dtype=np.float32), (4, 1, 1))
    p2p[:, :3, :3] = [[0, 0, 1.0], [-1 / 9, 0, 0.9], [0, -1 / 9, 0.7]]
    p2p[1:, 0, 3] = [0.5, -0.4, 1.0]
    return rgbd.astype(np.float32), p2p


# name -> (function name, args, kwargs) of every call compared
CALLS = {
    "instance_cmap": ("instance_cmap", (37,), {"seed": 4}),
    "colorize_depth": ("colorize_depth", (_depth(0),), {}),
    "colorize_scalar": ("colorize_scalar",
                        (np.where(_depth(1) > 5, _depth(1), np.nan),), {}),
    "colorize_scalar_range": ("colorize_scalar", (_depth(2), 3.0, 9.0),
                              {"cmap": "magma"}),
    "bev_label_instance": ("visualize_bev_label",
                           (R(3).integers(0, 30, (20, 24)),), {}),
    "bev_label_semantic": ("visualize_bev_label",
                           (R(4).integers(0, 26, (20, 24, 1)), "semantic"),
                           {}),
    "bev_label_elevation": ("visualize_bev_label",
                            (R(5).normal(size=(20, 24, 2)), "elevation"), {}),
    "overlay_trajectory": ("overlay_trajectory",
                           (np.zeros((20, 24, 3), np.uint8),
                            R(6).uniform(-2, 26, (9, 2))), {"radius": 2}),
    "bev_poses": ("visualize_bev_poses",
                  (np.full((20, 24, 3), 9, np.uint8),
                   np.tile(np.eye(3), (5, 1, 1)) + R(7).uniform(
                       0, 20, (5, 3, 3))), {}),
    "bev_policy": ("visualize_bev_policy", (_policy(8),), {}),
    "reward": ("visualize_reward", (R(9).normal(size=(16, 20)),
                                    R(10).uniform(size=(16, 20)) < 0.5), {}),
    "features_to_rgb": ("features_to_rgb", (R(11).normal(size=(8, 10, 6)),),
                        {}),
    "elevation_relative": ("show_elevation_map",
                           (np.where(_depth(12) > 3, _depth(12), np.inf),),
                           {}),
    "elevation_absolute": ("show_elevation_map", (_depth(13) - 5,),
                           {"color_scale": "absolute"}),
    "bev_heatmap": ("draw_bev_heatmap",
                    (R(14).normal(size=(20, 24)), _rgb(15, 20, 24)), {}),
    "dino_feature": ("visualize_dino_feature",
                     (_rgb(16), R(17).normal(size=(6, 7, 5))), {}),
    "preds_composite": ("save_preds_composite",
                        (_rgb(18), _depth(19), R(20).normal(size=(24, 30)),
                         R(21).uniform(size=(24, 30)) < 0.5), {}),
    "sparse_depth": ("draw_sparse_depth_on_image",
                     (_rgb(22), _depth(23) * (R(24).uniform(
                         size=(24, 30)) < 0.1)), {}),
    "bev_map": ("show_bev_map", (R(25).normal(size=(1, 12, 14, 5)),
                                 np.abs(R(26).normal(size=(2, 12, 14, 3)))),
                {}),
    "action_label": ("visualize_action_label",
                     (R(27).uniform(size=(5, 8)), R(28).uniform(size=(5, 8))),
                     {}),
    "rgbd_bev": ("visualize_rgbd_bev",
                 (_rgb(29, 12, 16), R(30).uniform(-14, 14, (12, 16, 3))),
                 {"grid": 64}),
    "masks_on_image": ("show_masks_on_image",
                       (_rgb(31), R(32).integers(0, 5, (24, 30))), {}),
    "bev_bbox": ("draw_bev_bbox", (np.zeros((20, 24, 3), np.uint8),
                                   (3, -2, 15, 30)), {"thickness": 2}),
    "text": ("draw_text_on_image", (_rgb(33, 30, 60), "Input"), {}),
    "side_by_side": ("side_by_side",
                     (np.zeros((10, 4, 3), np.uint8),
                      np.full((7, 5), 200, np.uint8)), {}),
    "resize_and_pad": ("resize_and_pad_image",
                       ((_rgb(34) * 255).astype(np.uint8), 40, 40), {}),
    "minmax_u8": ("_minmax_u8", (R(35).normal(size=(9, 11)),), {}),
    "alpha": ("apply_alpha_to_image",
              (_rgb(36), R(37).uniform(size=(24, 30)), np.ones(3)), {}),
    "to_vis_frame": ("_to_vis_frame", (R(38).normal(size=(50, 3)),), {}),
    "scatter_topdown": ("_scatter_topdown",
                        (R(39).normal(scale=6, size=(400, 3)), None, 64,
                         9.0), {"center": (0.0, 4.0)}),
    "pc_3d": ("visualize_pc_3d", (R(40).normal(scale=8, size=(900, 4)),),
              {}),
    "rgbd_3d": ("visualize_rgbd_3d", _rgbd3d(41), {}),
    "rgbd_3d_zfilter": ("visualize_rgbd_3d", _rgbd3d(42),
                        {"do_z_filtering": True, "z_max": 0.5}),
    "action_image": ("visualize_action_image", (None, None, None), {}),
}


@pytest.mark.parametrize("case", list(CALLS))
def test_function_equals_jax(case):
    fn, args, kw = CALLS[case]
    got = getattr(vz, fn)(*args, **kw)
    want = getattr(jvz, fn)(*args, **kw)
    if want is None:
        assert got is None
        return
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


def test_written_files_equal_jax(tmp_path):
    pts = R(43).normal(size=(20, 3))
    vz.numpy_to_pcd(pts, str(tmp_path / "a.pcd"))
    jvz.numpy_to_pcd(pts, str(tmp_path / "b.pcd"))
    assert (tmp_path / "a.pcd").read_text() == (tmp_path / "b.pcd").read_text()
    img = (_rgb(44) * 255).astype(np.uint8)
    vz.save_png(str(tmp_path / "a.png"), img)
    jvz.save_png(str(tmp_path / "b.png"), img)
    assert (tmp_path / "a.png").read_bytes() == (tmp_path / "b.png").read_bytes()
    got = vz.save_depth_color_image(_rgb(45), _depth(46),
                                    str(tmp_path / "c.png"))
    want = jvz.save_depth_color_image(_rgb(45), _depth(46),
                                      str(tmp_path / "d.png"))
    assert np.array_equal(got, want)
    assert (tmp_path / "c.png").read_bytes() == (tmp_path / "d.png").read_bytes()
    got = vz.visualize_pc_3d(R(47).normal(size=(50, 3)),
                             str(tmp_path / "e.png"))
    assert os.path.exists(tmp_path / "e.png")


def _turbo_index(img: np.ndarray) -> np.ndarray:
    """Each pixel's index in the turbo table, -1 for white, -2 for any
    other colour."""
    lut = COLORMAPS["turbo"].astype(np.int64)
    key = lambda a: (a[..., 0] << 16) | (a[..., 1] << 8) | a[..., 2]  # noqa
    table = dict(zip(key(lut).tolist(), range(len(lut))))
    table[key(np.array([255, 255, 255]))] = -1
    return np.vectorize(lambda k: table.get(k, -2))(key(img.astype(np.int64)))


def test_elevation_3d_structure():
    flat = np.full((32, 40), 0.3, np.float32)
    got = vz.visualize_elevation_3d(flat, flat)
    want = jvz.visualize_elevation_3d(flat, flat)
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    assert got.shape == (320, 640, 3)
    one = vz.visualize_elevation_3d(flat)
    assert one.shape == jvz.visualize_elevation_3d(flat).shape
    idx = _turbo_index(one)
    assert set(np.unique(idx)) == {-1, 0}

    def square(height):
        m = np.zeros((32, 40), np.float32)
        m[12:20, 16:24] = height
        m[0, 0] = 2.0  # one common colour scale for both heights
        return m

    low, high = (_turbo_index(vz.visualize_elevation_3d(square(h)))
                 for h in (0.8, 1.6))
    for idx in (low, high):
        assert (idx != -2).all()
        raised = idx > 40
        assert raised.sum() > 50
        # the surround is the ground's lowest colour
        ground = (idx >= 0) & ~raised
        assert (idx[ground] < 5).mean() > 0.95
    rows = np.nonzero(low > 40)[0].mean(), np.nonzero(high > 40)[0].mean()
    assert rows[1] < rows[0] - 5
    # non-finite cells take fill_value, as in JAX
    nan = square(1.0)
    nan[3, 3] = np.nan
    assert vz.visualize_elevation_3d(nan).shape == (320, 320, 3)
