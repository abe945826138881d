"""The port's scan viewer and point-cloud figures.

``export_html_viewer`` writes the JAX package's bytes for the same scans,
labels, point size and title, and ``python -m
creste_public_tpu_torch.visualize_scans`` the JAX script's file for the
same tree. ``PointCloudFigure`` draws without matplotlib (the card's
machine has none), with its own rasteriser: no axes, panes or
antialiasing, so its pixels are not matplotlib's, and pixel equality with
the JAX package's figures is not asked. The tests hold its geometry
instead: the module imports and renders with matplotlib blocked, a point
lands where the projection puts it, a near point hides a far one, the
colours follow height through the turbo table, the mesh and a trajectory
draw inside the frame, and ``show`` without a display raises.
"""
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from creste_public_tpu.utils.pointcloud_vis import (
    export_html_viewer as jexport_html_viewer,
)
from creste_public_tpu_torch.utils import pointcloud_vis as pv
from creste_public_tpu_torch.utils.colormaps import TURBO
from tests.test_torch_step_helpers import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def scans(n: int = 3, points: int = 200, stride: int = 4):
    rng = np.random.default_rng(0)
    return [rng.uniform(-5, 5, (points + 10 * i, stride)).astype(np.float32)
            for i in range(n)]


@pytest.mark.parametrize("case", ["one_array", "list_with_labels",
                                  "xyz_only", "hostile_title"])
def test_html_viewer_bytes_equal(tmp_path, case):
    s = scans()
    kwargs = {}
    if case == "one_array":
        s = s[0]
    elif case == "list_with_labels":
        kwargs["labels"] = [np.arange(len(s[0])) % 7, None,
                            np.arange(len(s[2]), dtype=np.uint32)]
        kwargs["point_size"] = 3
    elif case == "xyz_only":
        s = [a[:, :3] for a in s]
    else:
        kwargs["title"] = 'seq "0" </script><script>alert(1)</script> & <b>'
    got = pv.export_html_viewer(str(tmp_path / "port" / "v.html"), s,
                                **kwargs)
    want = jexport_html_viewer(str(tmp_path / "jax" / "v.html"), s, **kwargs)
    with open(got, "rb") as a, open(want, "rb") as b:
        assert a.read() == b.read()


def test_imports_and_renders_without_matplotlib(tmp_path):
    code = (
        "import sys\n"
        "sys.modules['matplotlib'] = None\n"
        "import numpy as np\n"
        "from creste_public_tpu_torch.utils import pointcloud_vis as pv\n"
        "pts = np.random.default_rng(0).uniform(-5, 5, (500, 4))\n"
        f"pv.render_scan(pts, {str(tmp_path / 'scan.png')!r}, size=4.0, "
        "device='cpu')\n"
        "f = pv.PointCloudFigure(device='cpu', figsize=(3, 3))\n"
        "f.draw_mesh_grid(np.random.default_rng(1).normal(size=(8, 8)))\n"
        f"f.save({str(tmp_path / 'mesh.png')!r})\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    from PIL import Image

    for name, hw in (("scan.png", (800, 800)), ("mesh.png", (300, 300))):
        img = np.asarray(Image.open(tmp_path / name))
        assert img.shape == (*hw, 3)
        assert (img != 255).any(axis=-1).sum() > 100


def frame_points():
    """The corners of a 10 x 6 x 2 box, which set the figure's limits."""
    return np.stack(np.meshgrid([0.0, 10.0], [-3.0, 3.0], [0.0, 2.0],
                                indexing="ij"), -1).reshape(-1, 3)


@pytest.mark.parametrize("elev, azim", [(35.0, -60.0), (60.0, 30.0),
                                        (10.0, 180.0)])
def test_points_land_where_projected(elev, azim):
    rng = np.random.default_rng(2)
    pts = rng.uniform([0, -3, 0], [10, 3, 2], (40, 3))
    fig = pv.PointCloudFigure(device="cpu", figsize=(4, 3), elev=elev,
                              azim=azim)
    fig.draw_points(frame_points(), colors="black")
    fig.draw_points(pts, colors=np.full((40, 3), [0, 0, 255], np.uint8))
    img = fig.to_array()
    assert img.shape == (300, 400, 3)
    col, row, depth = fig.project(pts)
    assert (depth > 0).all()
    r, c = np.floor(row).astype(int), np.floor(col).astype(int)
    assert ((r >= 15) & (r < 285) & (c >= 20) & (c < 380)).all()
    seen = np.all(img[r, c] == [0, 0, 255], axis=-1)
    # single-pixel splats can hide one another; most are in front
    assert seen.mean() > 0.8
    # nothing blue lands off the projected pixels
    blue = np.argwhere(np.all(img == [0, 0, 255], axis=-1))
    assert set(map(tuple, blue)) <= set(zip(r, c))


def test_near_point_hides_far_one():
    fig = pv.PointCloudFigure(device="cpu", figsize=(2, 2))
    fig.draw_points(frame_points(), colors="black")
    lo, hi = frame_points().min(0), frame_points().max(0)
    centre = (lo + hi) / 2
    # toward the eye in data units: the camera's direction scaled back out
    # of the 4 : 4 : 3 box
    eye, _, _, _ = fig._camera()
    toward = eye / pv.BOX * (hi - lo)
    near, far = centre + 0.2 * toward / np.linalg.norm(eye), centre
    (cn, cf), (rn, rf), (dn, df) = fig.project(np.stack([near, far]))
    assert dn < df
    assert (int(cn), int(rn)) == (int(cf), int(rf))
    for order in ((far, near), (near, far)):
        fig2 = pv.PointCloudFigure(device="cpu", figsize=(2, 2))
        fig2.draw_points(frame_points(), colors="black")
        fig2.draw_points(np.stack(order), size=9.0,
                         colors=np.array([[255, 0, 0], [0, 255, 0]])
                         if order[0] is far else
                         np.array([[0, 255, 0], [255, 0, 0]]))
        img = fig2.to_array()
        # the near point is green whichever was drawn first
        np.testing.assert_array_equal(img[int(rn), int(cn)], [0, 255, 0])


def test_height_colours_follow_height():
    z = np.linspace(0.0, 2.0, 9)
    pts = np.stack([np.linspace(0, 10, 9), np.zeros(9), z], 1)
    fig = pv.PointCloudFigure(device="cpu", figsize=(4, 4), elev=0.0,
                              azim=-90.0)
    fig.draw_points(pts, size=4.0)
    img = fig.to_array()
    col, row, _ = fig.project(pts)
    got = img[np.floor(row).astype(int), np.floor(col).astype(int)]
    want = TURBO[np.clip((z / 2.0 * 256).astype(int), 0, 255)]
    np.testing.assert_array_equal(got, want)
    # intensity colouring reads the fourth column
    fig = pv.PointCloudFigure(device="cpu", figsize=(4, 4), elev=0.0,
                              azim=-90.0)
    fig.draw_points(np.concatenate([pts, z[::-1, None]], 1),
                    color_by="intensity", size=4.0)
    got = fig.to_array()[np.floor(row).astype(int),
                         np.floor(col).astype(int)]
    np.testing.assert_array_equal(got, want[::-1])


def test_mesh_and_trajectory_draw_inside_the_frame():
    yy, xx = np.mgrid[0:24, 0:24]
    hm = np.sin(xx / 4.0) + np.cos(yy / 5.0)
    hm[2:5, 2:5] = np.nan
    valid = np.ones_like(hm, bool)
    valid[-3:] = False
    fig = pv.PointCloudFigure(device="cpu", figsize=(3, 3))
    fig.draw_mesh_grid(hm, valid=valid)
    traj = np.stack([np.linspace(0, 2.3, 20), np.linspace(0, 2.3, 20),
                     np.full(20, 3.0)], 1)
    fig.draw_trajectory(traj, color="red", lw=2.0)
    img = fig.to_array()
    assert img.shape == (300, 300, 3)
    drawn = np.argwhere((img != 255).any(axis=-1))
    assert len(drawn) > 0.1 * 300 * 300
    assert drawn.min() >= 15 - 1 and drawn.max() <= 285
    # the trajectory rides above the surface: its red shows unoccluded
    red = np.all(img == [255, 0, 0], axis=-1)
    col, row, _ = fig.project(traj)
    assert red[np.floor(row).astype(int), np.floor(col).astype(int)].all()
    # the mesh holds more than one shade of viridis
    mesh = img[(img != 255).any(axis=-1) & ~red]
    assert len(np.unique(mesh, axis=0)) > 20


def test_show_without_a_display_raises(monkeypatch):
    monkeypatch.delenv("DISPLAY", raising=False)
    monkeypatch.delenv("WAYLAND_DISPLAY", raising=False)
    fig = pv.PointCloudFigure(device="cpu", figsize=(1, 1)).draw_points(
        frame_points())
    with pytest.raises(RuntimeError, match="no display"):
        fig.show()


@pytest.fixture(scope="module")
def raw_tree(tmp_path_factory):
    from creste_public_tpu_torch.data.raw_synthetic import write_raw_coda_tree

    root = str(tmp_path_factory.mktemp("raw"))
    write_raw_coda_tree(root, n_frames=4, img_hw=(64, 80))
    return root


def run_jax_viewer(args: list[str]) -> None:
    path = os.path.join(REPO, "scripts", "visualize_scans.py")
    spec = importlib.util.spec_from_file_location("_jax_visualize_scans",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    old = sys.argv
    sys.argv = [path, *args]
    try:
        mod.main()
    finally:
        sys.argv = old


@pytest.mark.parametrize("args", [[], ["--frames", "1", "3",
                                       "--labels", "3d_semantic",
                                       "--point-size", "3"]],
                         ids=["default", "frames_labels"])
def test_viewer_cli_writes_the_jax_scripts_file(raw_tree, tmp_path, args):
    from PIL import Image

    from creste_public_tpu_torch import visualize_scans

    common = ["--root", raw_tree, "--seq", "0", *args]
    run_jax_viewer([*common, "--out", str(tmp_path / "jax.html")])
    png = tmp_path / "png"
    out = visualize_scans.main([*common, "--out", str(tmp_path / "port.html"),
                                "--png", str(png), "--device", "cpu"])
    with open(out, "rb") as a, open(tmp_path / "jax.html", "rb") as b:
        assert a.read() == b.read()
    frames = ["1", "3"] if args else ["0", "1", "2", "3"]
    assert sorted(os.listdir(png)) == sorted(f"{f}.png" for f in frames)
    img = np.asarray(Image.open(png / f"{frames[0]}.png"))
    assert img.shape == (800, 800, 3) and (img != 255).any()


def test_figure_runs_on_the_card_unless_asked(tmp_path):
    """The figure and ``render_scan`` default to the card, as the port's
    entry points do: without one they refuse rather than fall back to the
    CPU, which a caller asks for with ``device="cpu"``."""
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pv.PointCloudFigure(figsize=(1, 1))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pv.render_scan(frame_points(), str(tmp_path / "scan.png"))
    assert pv.PointCloudFigure(figsize=(1, 1), device="cpu").device.type \
        == "cpu"
