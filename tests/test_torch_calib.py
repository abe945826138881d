"""The port's YAML-free calibration reader against ``yaml.safe_load``.

The two CODa calibration files (intrinsics, and the os1 -> camera
extrinsic) are written three ways: ``yaml.safe_dump`` in block style,
``yaml.safe_dump(default_flow_style=None)``, and by hand in the ROS style
(a ``data: [...]`` flow list over three lines, comments). The port's
``read_calibration_yaml`` reads each as ``yaml.safe_load`` does, and
``load_calibration``, ``scaled(0.5)`` and ``pixel_to_point(4)`` equal the
JAX package's exactly. Syntax outside the reader's subset raises
``ValueError`` naming its line.
"""
from __future__ import annotations

import os

import numpy as np
import pytest
import yaml

from creste_public_tpu.data import calib as jcalib
from creste_public_tpu_torch.data import calib
from tests.test_torch_coda_tree import calibration, ros_style

STYLES = {
    "block": yaml.safe_dump,
    "flow_none": lambda d: yaml.safe_dump(d, default_flow_style=None),
    "ros": ros_style,
}


def write_calibration(root: str, style: str, H: int = 1024, W: int = 1224):
    cal = calibration(H, W)
    cal["intrinsics"].update(camera_name="narrow_stereo/left",
                             distortion_model="plumb_bob")
    cal["intrinsics"]["distortion_coefficients"] = {
        "rows": 1, "cols": 5, "data": [-0.1, 0.01, -1.0e-05, 0.0, 0.0]}
    d = os.path.join(root, "calibrations", "3")
    os.makedirs(d, exist_ok=True)
    paths = []
    for name, doc in (("calib_cam0_intrinsics.yaml", cal["intrinsics"]),
                      ("calib_os1_to_cam0.yaml", cal["extrinsics"])):
        paths.append(os.path.join(d, name))
        with open(paths[-1], "w") as f:
            f.write(STYLES[style](doc))
    return paths


@pytest.mark.parametrize("style", list(STYLES))
def test_reader_equals_safe_load_and_jax(tmp_path, style):
    paths = write_calibration(str(tmp_path), style)
    for p in paths:
        with open(p) as f:
            want = yaml.safe_load(f)
        assert calib.read_calibration_yaml(p) == want
    if style == "ros":
        with open(paths[0]) as f:
            text = f.read()
        assert "#" in text and "data: [" in text and text.count("\n") > 12
    got = calib.load_calibration(str(tmp_path), 3)
    want = jcalib.load_calibration(str(tmp_path), 3)
    for c_got, c_want in ((got, want), (got.scaled(0.5), want.scaled(0.5))):
        for field in ("K", "R", "P", "lidar2cam", "lidar2camrect"):
            a, b = getattr(c_got, field), getattr(c_want, field)
            assert a.dtype == b.dtype and np.array_equal(a, b), field
        assert c_got.img_hw == c_want.img_hw
    for ds in (1.0, 4):
        a, b = got.pixel_to_point(ds), want.pixel_to_point(ds)
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_poses_equal_jax(tmp_path):
    rng = np.random.default_rng(0)
    rows = np.concatenate([rng.uniform(0, 10, (7, 4)),
                           rng.normal(size=(7, 4))], 1)
    os.makedirs(tmp_path / "poses" / "dense")
    np.savetxt(tmp_path / "poses" / "dense" / "5.txt", rows)
    assert np.array_equal(calib.poses_to_matrices(rows),
                          jcalib.poses_to_matrices(rows))
    assert np.array_equal(calib.load_poses(str(tmp_path), 5),
                          jcalib.load_poses(str(tmp_path), 5))
    assert np.array_equal(calib.quat_to_rotmat(rows[:, 4:]),
                          jcalib.quat_to_rotmat(rows[:, 4:]))


@pytest.mark.parametrize("text,line,what", [
    ("a: &x 1\nb: *x\n", 1, "an anchor"),
    ("a: 1\nb: !!float 2\n", 2, "a tag"),
    ("%YAML 1.1\n---\na: 1\n", 1, "a directive"),
    ("a: 1\n---\nb: 2\n", 2, "a document marker"),
    ("a:\n  b: |\n    text\n", 2, "a block scalar"),
    ("? a\n: b\n", 1, "a complex key"),
    ("a: [1, 2,\n  3\n", 1, "an unclosed flow collection"),
    ("a: b\n  c\n", 2, "an unexpected indentation"),
])
def test_unsupported_syntax_raises(text, line, what):
    with pytest.raises(ValueError, match=f"<string>:{line}: {what}"):
        calib.parse_calibration_yaml(text)
