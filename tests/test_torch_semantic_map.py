"""The port's semantic point map and its label writers
(``preprocessing/semantic_map.py``) against the JAX package's over one
raw synthetic tree and on seeded NumPy inputs.

Bars, all exact: per-point labels, crops, count bins (3d_ssc int64,
3d_soc uint16), descriptor bins and the shipped elevation labels (min,
max and variance: the port's Map2D sums the 3x3 windows in XLA's order and
rounds the variance as XLA's fused expression does).
"""
import os

import numpy as np
import pytest

from creste_public_tpu.preprocessing import semantic_map as jsem
from creste_public_tpu_torch.data.raw_synthetic import write_raw_coda_tree
from creste_public_tpu_torch.preprocessing import semantic_map as sem
from tests.test_torch_step_helpers import one_torch_thread  # noqa: F401

GRID, RANGE = 16, 1.6


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("semtree"))
    write_raw_coda_tree(root, n_frames=6, img_hw=(32, 40),
                        points_per_scan=1500, max_range=2 * RANGE,
                        speed=0.22, curve=0.015)
    rng = np.random.default_rng(0)
    for d in ("3d_objects/0", "labels_img/0", "feats/0"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    for f in range(6):
        rng.integers(0, 60, 1500).astype(np.uint32).tofile(
            os.path.join(root, "3d_objects/0", f"{f}.bin"))
        np.save(os.path.join(root, "labels_img/0", f"{f}.npy"),
                rng.integers(0, 25, (32, 40)))
        np.save(os.path.join(root, "feats/0", f"{f}.npy"),
                rng.normal(size=(8, 10, 6)).astype(np.float32))
    return root


def read_all(d: str) -> dict:
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d))}


@pytest.mark.parametrize("label_dir, num_classes, dtype, source", [
    ("3d_semantic", 25, "int64", "points"),
    ("3d_objects", 60, "uint16", "points"),
    ("labels_img", 25, "int64", "image")])
def test_count_bins_match_jax(tree, tmp_path, label_dir, num_classes, dtype,
                              source):
    kw = dict(grid=GRID, map_range=RANGE, num_classes=num_classes,
              out_dtype=dtype, window=3, chunk=4, label_source=source)
    nj = jsem.build_count_bins(tree, "0", label_dir, str(tmp_path / "j"),
                               **kw)
    np_ = sem.build_count_bins(tree, "0", label_dir, str(tmp_path / "p"),
                               workers=2, **kw)
    assert nj == np_ == 6
    want, got = read_all(tmp_path / "j" / "0"), read_all(tmp_path / "p" / "0")
    assert want == got
    total = sum(np.frombuffer(v, dtype).sum() for v in want.values())
    assert total > 1000


def test_elevation_bins_match_jax(tree, tmp_path):
    kw = dict(grid=GRID, map_range=RANGE, window=3, chunk=4)
    j = [str(tmp_path / d) for d in ("je", "jv")]
    p = [str(tmp_path / d) for d in ("pe", "pv")]
    assert jsem.build_elevation_bins(tree, "0", "3d_semantic", *j, **kw) == 6
    assert sem.build_elevation_bins(tree, "0", "3d_semantic", *p,
                                    device="cpu", **kw) == 6
    for f in range(6):
        name = os.path.join("0", f"{f}.bin")
        ew = np.fromfile(os.path.join(j[0], name), np.float32)
        eg = np.fromfile(os.path.join(p[0], name), np.float32)
        np.testing.assert_array_equal(eg, ew)
        assert np.isfinite(ew).sum() > 20
        vw = np.fromfile(os.path.join(j[1], name), np.float32)
        vg = np.fromfile(os.path.join(p[1], name), np.float32)
        np.testing.assert_array_equal(vg, vw)
    # a second run skips every frame that has both files
    assert sem.build_elevation_bins(tree, "0", "3d_semantic", *p,
                                    device="cpu", **kw) == 0


@pytest.mark.parametrize("aggregator", ["GMP", "GAP"])
def test_descriptor_bins_match_jax(tree, tmp_path, aggregator):
    kw = dict(grid=GRID, map_range=RANGE, window=3, chunk=4, ds=4,
              aggregator=aggregator)
    jsem.build_descriptor_bins(tree, "0", "feats", str(tmp_path / "j"), **kw)
    sem.build_descriptor_bins(tree, "0", "feats", str(tmp_path / "p"), **kw)
    want, got = read_all(tmp_path / "j" / "0"), read_all(tmp_path / "p" / "0")
    assert want == got and len(want) == 6
    assert any(np.frombuffer(v, np.float32).any() for v in want.values())


def test_point_helpers_match_jax():
    rng = np.random.default_rng(1)
    pts = rng.uniform(-3, 3, (2000, 3))
    pts[:, 0] += 4
    l2r = np.array([[0, -36.0, 20, 0], [0, 0, -36, 16], [1, 0, 0, 0]])
    img = rng.integers(0, 9, (32, 40, 2))
    for got, want in zip(sem.labels_from_image(pts, img, l2r),
                         jsem.labels_from_image(pts, img, l2r)):
        np.testing.assert_array_equal(got, want)
    cells = rng.integers(0, 8, (300, 2))
    desc = rng.normal(size=(300, 4))
    for agg in ("GMP", "GAP"):
        np.testing.assert_array_equal(
            sem.aggregate_descriptors(cells, desc, (8, 8), agg),
            jsem.aggregate_descriptors(cells, desc, (8, 8), agg))
    maps = [m((16, 16), (0.2, 0.2), (-1.6, -1.6, 1.6, 1.6))
            for m in (sem.SemanticPointMap, jsem.SemanticPointMap)]
    pose = np.eye(4)
    for k in range(3):
        pose[:2, 3] = [0.3 * k, -0.1 * k]
        labels = rng.integers(0, 5, 2000)
        for m in maps:
            m.add_frame(pts * 0.4, labels, pose.copy())
    for got, want in zip(maps[0].crop_at_pose(pose),
                         maps[1].crop_at_pose(pose)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(maps[0].scene_at_pose(pose, 5),
                                  maps[1].scene_at_pose(pose, 5))
