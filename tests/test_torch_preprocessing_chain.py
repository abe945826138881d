"""The preprocessing chain end to end: the port's eight entry points
(``python -m creste_public_tpu_torch.preprocessing.<name>``, run here
in-process through ``main(argv)`` with ``--device cpu``) and the JAX
package's scripts (``scripts/preprocessing``, through their argparse) in
``scripts/e2e_pipeline.py::preprocess``'s order, each over its own copy
of one tiny raw synthetic tree (12 frames of 64x80, grid 32 at 1.6 m).

Bars: every label file exact (depth PNGs and their 4x copies, the image
SAM labels, the BEV SAM maps, the elevation and variance bins, the
traversability starts and the split files) but the distillation maps, which
meet JAX's to 1e-5 of their largest value up to a sign per PCA component.
"""
import filecmp
import importlib
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from creste_public_tpu.data.raw_synthetic import write_raw_coda_tree
from tests.test_torch_step_helpers import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ, GRID, RANGE, FDN_HW, HORIZON = "0", 32, 1.6, (16, 20), 5
RTOL = 1e-5
# the label families of tests/test_e2e_pipeline.py, less the
# counterfactuals that annotation writes
FAMILIES = ("depth_5_LA_all/cam0/0", "depth_5_LA_all_ds4/cam0/0",
            "2d_sam/cam0/0", "2d_sam_dynamic/cam0/0", "distillation/cam0/0",
            "3d_sam/0", "3d_sam_dynamic/0", "elevation/0", "variance/0",
            "traversability", "splits")


def chain_steps(root: str) -> list[tuple[str, list]]:
    """(entry point, arguments) in e2e's order."""
    s = [str(a) for a in (GRID, RANGE)]
    depth_dir = os.path.join(root, "depth_5_LA_all")
    return [
        ("build_dense_depth", ["--root", root, "--seqs", SEQ, "--scans", "5",
                               "--proc", "LA", "--workers", "2"]),
        ("downsample_frames", ["--in_dir", depth_dir,
                               "--out_dir", depth_dir + "_ds4",
                               "--factor", "4"]),
        ("create_sam_dataset", ["--root", root, "--seqs", SEQ,
                                "--mode", "static"]),
        ("create_sam_dataset", ["--root", root, "--seqs", SEQ,
                                "--mode", "dynamic"]),
        ("create_pe_dataset", ["--root", root, "--seqs", SEQ,
                               "--pca_dim", "16", "--out_hw",
                               *map(str, FDN_HW)]),
        ("build_sam_map", ["--root", root, "--seqs", SEQ, "--mode", "static",
                           "--grid", s[0], "--map_range", s[1], "--ds", "4",
                           "--horizon", "3", "--workers", "1"]),
        ("build_sam_map", ["--root", root, "--seqs", SEQ, "--mode",
                           "dynamic", "--grid", s[0], "--map_range", s[1],
                           "--ds", "4", "--workers", "1"]),
        ("build_feature_map", ["--root", root, "--seqs", SEQ, "--tasks",
                               "elevation", "--grid", s[0], "--map_range",
                               s[1], "--scans", "5", "--window", "10",
                               "--workers", "1"]),
        ("create_traversability_dataset", ["--root", root, "--seqs", SEQ,
                                           "--num_frames", str(HORIZON),
                                           "--dist_thresh", "1.0"]),
        ("build_splits", ["--root", root, "--seqs", SEQ, "--horizon",
                          str(HORIZON), "--min_distance", "0.5"]),
    ]


def run_jax(name: str, args: list) -> None:
    path = os.path.join(REPO, "scripts", "preprocessing", name + ".py")
    spec = importlib.util.spec_from_file_location(f"_jax_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    old = sys.argv
    sys.argv = [path, *args]
    try:
        mod.main()
    finally:
        sys.argv = old


def run_port(name: str, args: list) -> None:
    mod = importlib.import_module(
        f"creste_public_tpu_torch.preprocessing.{name}")
    mod.main([*args, "--device", "cpu"])


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        # no hub lookups for the foundation models' weights
        mp.setenv("HF_HUB_OFFLINE", "1")
        for side, run in (("jax", run_jax), ("port", run_port)):
            root = str(tmp_path_factory.mktemp(side))
            write_raw_coda_tree(root, seq=SEQ, n_frames=12, img_hw=(64, 80),
                                speed=0.22, curve=0.015, max_range=2 * RANGE)
            for name, args in chain_steps(root):
                run(name, args)
            out[side] = root
    return out


def test_chain_writes_every_label_family(trees):
    root = trees["port"]
    for d in FAMILIES:
        assert os.listdir(os.path.join(root, d)), f"missing labels: {d}"
    assert len(os.listdir(os.path.join(root, "3d_sam", SEQ))) == 12
    assert os.path.exists(os.path.join(root, "splits", "train.txt"))
    assert os.path.getsize(os.path.join(root, "traversability", "0.txt"))


@pytest.mark.parametrize("family", FAMILIES)
def test_chain_matches_jax(trees, family):
    a, b = (os.path.join(trees[s], family) for s in ("jax", "port"))
    names = sorted(os.listdir(a))
    assert names and names == sorted(os.listdir(b))
    for f in names:
        pa, pb = os.path.join(a, f), os.path.join(b, f)
        if family.startswith("distillation"):
            want, got = np.load(pa), np.load(pb)
            assert got.shape == want.shape == (*FDN_HW, 16)
            sign = np.sign((got * want).sum(axis=(0, 1)))
            np.testing.assert_allclose(got * sign, want, rtol=0,
                                       atol=RTOL * np.abs(want).max())
        else:
            assert filecmp.cmp(pa, pb, shallow=False), f"{family}/{f}"


def test_foundation_models_absent(trees, monkeypatch):
    """Without weights the HF loaders return None and ``auto`` extracts
    with the random projection (what the chain above ran); ``dinov2``
    asked for by name raises."""
    from creste_public_tpu_torch.preprocessing import features
    from creste_public_tpu_torch.preprocessing import video_tracking as vt

    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    for name in ("CRESTE_GROUNDING_DINO", "CRESTE_SAM_MODEL",
                 "CRESTE_DINOV2_MODEL"):
        monkeypatch.setenv(name, "/nonexistent/weights")
    assert vt.try_load_detector(device="cpu") is None
    assert vt.try_load_mask_predictor(device="cpu") is None
    assert vt.try_load_auto_mask_generator(device="cpu") is None
    ext = features.build_extractor("auto", stride=7, device="cpu")
    assert isinstance(ext, features.RandomProjectionExtractor)
    assert ext.stride == 7 and ext.device == torch.device("cpu")
    with pytest.raises(Exception):
        features.build_extractor("dinov2", device="cpu")
