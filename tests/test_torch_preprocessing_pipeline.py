"""The port's depth labels (``preprocessing/depth.py``), splits
(``preprocessing/splits.py``) and feature labels
(``preprocessing/features.py``) against the JAX package's on seeded NumPy
inputs and one raw synthetic tree.

Bars: LA depth frames and their PNGs exact; LAIDW frames (the 50-scan
bottom refill, then IDW) to 1e-5 of the largest depth; split and
traversability files exact; the PCA basis and the projected, resized
feature maps to 1e-5 of their largest value up to a sign per component
(LAPACK's sign in JAX, the port's largest-entry-positive rule); the random
projection's patch features (f64: NumPy promotes its f32 draws by an f64
scale, and both sides keep that) to 1e-12. (The extractor's fallback
without DINOv2 weights is checked in tests/test_torch_preprocessing_chain
.py, whose process imports transformers anyway.)
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from creste_public_tpu.data.calib import load_calibration as jload_calib
from creste_public_tpu.preprocessing import depth as jdepth
from creste_public_tpu.preprocessing import features as jfeat
from creste_public_tpu.preprocessing import splits as jsplits
from creste_public_tpu_torch.data.calib import load_calibration, load_poses
from creste_public_tpu_torch.data.raw_synthetic import write_raw_coda_tree
from creste_public_tpu_torch.preprocessing import depth
from creste_public_tpu_torch.preprocessing import features as feat
from creste_public_tpu_torch.preprocessing import splits
from tests.test_torch_step_helpers import one_torch_thread  # noqa: F401

RTOL = 1e-5


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("rawtree"))
    write_raw_coda_tree(root, n_frames=8, img_hw=(48, 64),
                        points_per_scan=3000, max_range=6.0)
    return root


def frame_inputs(root: str, frame: int, scans: int, bottom: bool):
    poses = load_poses(root, "0")
    ids = np.clip(np.arange(frame - scans // 2, frame - scans // 2 + scans),
                  0, len(poses) - 1)
    bids = np.clip(np.arange(frame - 25, frame + 25), 0, len(poses) - 1)
    xyz = [depth.load_scan(root, "0", int(i)) for i in ids]
    out = dict(scans_xyz=xyz, scan_poses=poses[ids], ref_pose=poses[frame])
    if bottom:
        out.update(bottom_scans_xyz=[depth.load_scan(root, "0", int(i))
                                     for i in bids],
                   bottom_poses=poses[bids])
    return out


@pytest.mark.parametrize("proc", ["LA", "LAIDW"])
def test_depth_frame_matches_jax(tree, proc):
    calib, jcalib = load_calibration(tree, "0"), jload_calib(tree, "0")
    for frame in (0, 5):
        kw = frame_inputs(tree, frame, 5, proc == "LAIDW")
        want = jdepth.compute_depth_frame(calib=jcalib, img_hw=jcalib.img_hw,
                                          proc=proc, **kw)
        got = depth.compute_depth_frame(calib=calib, img_hw=calib.img_hw,
                                        proc=proc, device="cpu", **kw)
        assert (want > 0).sum() > 200
        if proc == "LA":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=RTOL * want.max())
    with pytest.raises(ValueError):
        depth.compute_depth_frame(calib=calib, img_hw=calib.img_hw,
                                  proc="LIDW", device="cpu", **kw)


def test_sequence_depth_pngs_match_jax(tree, tmp_path):
    a, b = str(tmp_path / "j"), str(tmp_path / "p")
    wa = jdepth.build_sequence_depth(tree, "0", range(8), out_root=a)
    wb = depth.build_sequence_depth(tree, "0", range(8), out_root=b,
                                    workers=2, device="cpu")
    assert [os.path.relpath(p, a) for p in wa] == [
        os.path.relpath(p, b) for p in wb]
    for pa, pb in zip(wa, wb):
        assert open(pa, "rb").read() == open(pb, "rb").read()
    assert depth.build_sequence_depth(tree, "0", range(8), out_root=b,
                                      device="cpu") == []


def arc_rows(n: int, curve: float, speed: float = 0.1) -> np.ndarray:
    yaw = curve * np.arange(n)
    rows = np.zeros((n, 8))
    rows[:, 1] = np.concatenate([[0], np.cumsum(speed * np.cos(yaw[:-1]))])
    rows[:, 2] = np.concatenate([[0], np.cumsum(speed * np.sin(yaw[:-1]))])
    rows[:, 4], rows[:, 7] = np.cos(yaw / 2), np.sin(yaw / 2)
    return rows


def test_splits_match_jax(tmp_path):
    from creste_public_tpu_torch.data.calib import poses_to_matrices

    rows = np.concatenate([arc_rows(80, 0.0), arc_rows(80, 0.03)])
    mats = poses_to_matrices(rows)
    got = splits.classify_curvature(mats, range(0, 160, 3), horizon=40,
                                    min_distance=1.0)
    want = jsplits.classify_curvature(mats, range(0, 160, 3), horizon=40,
                                      min_distance=1.0)
    assert got == want and got[0] and got[1]
    samples = [("0", f) for f in got[0] + got[1]] + [("1", 3), ("1", 9)]
    assert splits.train_val_test(samples, seed=3) == jsplits.train_val_test(
        samples, seed=3)
    assert splits.drop_overlapping_horizons(samples, 10) == \
        jsplits.drop_overlapping_horizons(samples, 10)
    for mod, d in ((splits, "p"), (jsplits, "j")):
        mod.write_split_files(str(tmp_path / d), mod.train_val_test(samples),
                              {("0", f): v for f, v in got[2].items()})
    for f in sorted(os.listdir(tmp_path / "j")):
        assert open(tmp_path / "p" / f).read() == open(tmp_path / "j" /
                                                        f).read(), f
    for dist in (0.5, 2.0):
        np.testing.assert_array_equal(
            splits.traversability_starts(rows, 20, dist_thresh=dist),
            jsplits.traversability_starts(rows, 20, dist_thresh=dist))


def same_up_to_sign(got: np.ndarray, want: np.ndarray, axis_sum) -> None:
    sign = np.sign((got * want).sum(axis=axis_sum))
    assert (sign != 0).all()
    np.testing.assert_allclose(got * sign, want, rtol=0,
                               atol=RTOL * np.abs(want).max())


@pytest.mark.parametrize("out_hw", [(12, 15), (40, 52)],
                         ids=["shrink", "grow"])
def test_pca_matches_jax(out_hw):
    rng = np.random.default_rng(0)
    basis = rng.normal(size=(6, 32))
    samples = (rng.normal(size=(800, 6)) * [5, 4, 3, 2, 1, 0.5] @ basis
               + rng.normal(size=(800, 32)) * 0.01).astype(np.float32)
    jm, jc = jfeat.pca_fit(jnp.asarray(samples), k=4)
    pm, pc = feat.pca_fit(torch.from_numpy(samples), k=4)
    np.testing.assert_allclose(pm.numpy(), np.asarray(jm), rtol=0, atol=1e-6)
    same_up_to_sign(pc.numpy(), np.asarray(jc), 0)
    feats = rng.normal(size=(2, 20, 26, 32)).astype(np.float32)
    want = np.asarray(jfeat.pca_project_resize(jnp.asarray(feats), jm, jc,
                                               out_hw))
    got = feat.pca_project_resize(torch.from_numpy(feats), pm, pc,
                                  out_hw).numpy()
    assert got.shape == want.shape == (2, *out_hw, 4)
    same_up_to_sign(got, want, (0, 1, 2))
    # the sign rule: each component's largest entry is positive
    big = np.abs(pc.numpy()).argmax(0)
    assert (pc.numpy()[big, range(4)] > 0).all()


def test_feature_extractor_matches_jax():
    rng = np.random.default_rng(1)
    images = rng.uniform(size=(2, 48, 62, 3)).astype(np.float32)
    for stride in (7, 14):
        want = jfeat.RandomProjectionExtractor(feature_dim=24,
                                               stride=stride)(images)
        got = feat.RandomProjectionExtractor(feature_dim=24, stride=stride,
                                             device="cpu")(images)
        assert got.shape == want.shape == (
            2, *jfeat.patch_grid_shape(48, 62, 14, stride), 24)
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    flats = [rng.normal(size=(30, 40, 8)) for _ in range(3)]
    np.testing.assert_array_equal(feat.sample_features(flats, 500, seed=2),
                                  jfeat.sample_features(flats, 500, seed=2))
    assert feat.dino_input_shape("dinov2", (1024, 1224)) == \
        jfeat.dino_input_shape("dinov2", (1024, 1224))
