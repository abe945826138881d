"""The port's CODa reader against the JAX package's, on one synthesized
CODa tree (``tests/test_torch_coda_tree.py``: two sequences of 64x80
frames, grid 32, calibration in the block and the ROS flow style,
elevation as ``.bin`` in one sequence and legacy ``.npy`` in the other,
one frame without its static SAM map).

Both readers are built from the same config, and every key of every
sample must be equal, dtype and bits (tolerance 0), under seven configs:
the default, ``image_size`` (the resize and the intrinsics scaling),
``views: 3`` (the multiview path), ``use_movability`` with
``load_point_cloud``, ``fov_horizon: 3``, ``resample_trajectories`` with
``min_deviation``, and the split whose frame has no SAM map (the ``_try``
paths). The JAX reader runs its PIL branch (its C library is not asked
for), which is what the port's decoding equals. The split helpers meet
JAX's with the same generator; the dataset pickles, and the port's loader
in process mode gives the batches of its thread mode.
"""
from __future__ import annotations

import pickle

import numpy as np
import pytest

from creste_public_tpu.data import coda_dataset as jcd
from creste_public_tpu.data import native_io as jnative_io
from creste_public_tpu_torch.data import coda_dataset as cd
from creste_public_tpu_torch.data.dataloader import EpochLoader, build_dataset
from tests.test_torch_coda_tree import write_coda_tree

CONFIGS = {
    "default": {},
    "image_size": {"image_size": [48, 60]},
    "views3": {"views": 3},
    "movability_points": {"use_movability": True, "load_point_cloud": True,
                          "points_per_scan": 600},
    "fov_horizon3": {"fov_horizon": 3},
    "resample": {"resample_trajectories": True, "min_deviation": 1.5},
    "missing_sam": {"train_split": "partial"},
}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("coda"))
    return root, write_coda_tree(root)


@pytest.fixture(scope="module", autouse=True)
def jax_pil_branch():
    """The JAX reader's PIL decoding (its C library is gitignored and may
    or may not be built)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jnative_io, "available", lambda: False)
    yield
    mp.undo()


def config(root: str, **kw) -> dict:
    return {"name": "coda", "root": root, "views": 1, "ds": 4, "grid": 32,
            "map_range": 1.6, "horizon": 10, "n_counterfactuals": 4, **kw}


def assert_same(got, want, where=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), where
        for k in want:
            assert_same(got[k], want[k], f"{where}/{k}")
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (where, got.dtype, want.dtype)
    assert got.shape == want.shape, (where, got.shape, want.shape)
    assert np.array_equal(got, want, equal_nan=True), where


@pytest.mark.parametrize("name", list(CONFIGS))
def test_samples_equal_jax(tree, name):
    root, _ = tree
    cfg = config(root, **CONFIGS[name])
    for split in ("train", "val"):
        want = jcd.CodaDataset(cfg, split=split)
        got = cd.CodaDataset(cfg, split=split, device="cpu")
        assert got.infos == want.infos and len(got) > 0
        for i in range(len(want)):
            assert_same(got[i], want[i], f"{name}/{split}/{i}")
    train = cd.CodaDataset(cfg, split="train", device="cpu")
    if name == "missing_sam":
        assert "3d_sam_label" not in train[0]
    if name == "views3":
        assert train[0]["image"].shape[0] == 3
        # a real overlap search: some view is another frame than the anchor
        assert any(not np.array_equal(train[i]["p2p"][1], train[i]["p2p"][0])
                   for i in range(len(train)))


def test_split_helpers_equal_jax(tree):
    root, splits = tree
    rows = cd.read_split(root, "train")
    assert rows == jcd.read_split(root, "train") == splits["train"]
    for resample in (False, True):
        for dev in (0.0, 2.0):
            np.random.seed(0)
            a = cd.filter_split(root, "train", rows, dev, resample)
            np.random.seed(0)
            assert a == jcd.filter_split(root, "train", rows, dev, resample)
    dist = np.random.default_rng(0).gamma(2.0, 2.0, 300)
    samples = list(range(300))
    for bins in (5, 20):
        a = cd.balanced_infos_resampling(samples, dist, bins,
                                         np.random.RandomState(3))
        b = jcd.balanced_infos_resampling(samples, dist, bins,
                                          np.random.RandomState(3))
        assert a[0] == b[0] and np.array_equal(a[1], b[1])
    rng = np.random.default_rng(1)
    x = rng.integers(0, 4, (12, 14)) * (rng.uniform(size=(12, 14)) < 0.6)
    for k in (3, 5):
        assert_same(cd.median_filter_2d(x, k), jcd.median_filter_2d(x, k))
        assert_same(cd.expand_filter_2d(x, k), jcd.expand_filter_2d(x, k))
    assert_same(cd.remap_contiguous(x * 7), jcd.remap_contiguous(x * 7))


def test_build_dataset_pickles_and_process_mode(tree):
    root, _ = tree
    cfg = config(root, use_movability=True)
    ds = build_dataset(cfg, "train", "cpu")
    assert isinstance(ds, cd.CodaDataset)
    first = ds[0]  # fills the calibration and pose caches
    again = pickle.loads(pickle.dumps(ds))
    assert_same(again[0], first)
    kw = dict(batch_size=2, shuffle=True, seed=3, num_workers=2)
    thread = EpochLoader(ds, **kw)
    proc = EpochLoader(build_dataset(cfg, "train", "cpu"),
                       worker_mode="process", **kw)
    try:
        a, b = list(thread.epoch(1)), list(proc.epoch(1))
        assert len(a) == len(b) == len(ds) // 2
        for ba, bb in zip(a, b):
            assert_same(bb, ba)
    finally:
        thread.close()
        proc.close()


def test_native_io_equals_the_pil_branch(tree):
    """The port's decoders give what the JAX reader's PIL branch reads
    (``coda_dataset.py:215-217, 231``)."""
    from PIL import Image

    from creste_public_tpu_torch.data import native_io

    root, _ = tree
    jpg = f"{root}/2d_rect/cam0/0/2d_rect_cam0_0_1.jpg"
    png = f"{root}/depth_5_LA_all/cam0/0/1.png"
    rgb = np.asarray(Image.open(jpg).convert("RGB"), np.float32) / 255.0
    depth = np.asarray(Image.open(png), np.float32)
    assert native_io.jpeg_shape(jpg) == (64, 80, 3)
    assert native_io.png16_shape(png) == (64, 80)
    assert_same(native_io.decode_jpeg(jpg).astype(np.float32) / 255.0, rgb)
    assert_same(native_io.decode_png16(png).astype(np.float32), depth)
    assert native_io.decode_png16(png).dtype == np.uint16
    rgbd = np.concatenate([rgb, depth[..., None]], -1)
    assert_same(native_io.assemble_rgbd(jpg, png), rgbd)
    assert_same(native_io.assemble_rgbd(jpg, None)[..., 3],
                np.zeros((64, 80), np.float32))
    pa = native_io.ParallelAssembler(2)
    try:
        assert_same(pa.assemble_batch([(jpg, png)] * 3), np.stack([rgbd] * 3))
    finally:
        pa.close()
    scan = f"{root}/3d_raw/os1/0/3d_raw_os1_0_2.bin"
    raw = np.fromfile(scan, np.float32)
    assert_same(native_io.read_bin(scan), raw)
    assert_same(native_io.read_bin(scan, 10), raw[:10])
    with pytest.raises(OSError):
        native_io.read_bin(f"{root}/missing.bin")
