"""The port's foundation-model wrappers (``preprocessing/video_tracking.py``
GroundingDINO, SAM and SAM's automatic masks; ``preprocessing/features.py``
DINOv2) over tiny random-weight checkpoints in the real HF layouts, against
the JAX package's wrappers over the same checkpoints (both run the HF
torch models; tests/test_real_backends.py builds the same artifacts).

Held: every wrapper moves its model and its inputs to the device it was
given, and refuses ``device="cuda"`` on a machine without CUDA instead of
running on the CPU; the loaders return None without weights and without
importing transformers; boxes, classes and masks equal JAX's exactly,
DINOv2 features to 1e-5 of their largest magnitude; the
``create_sam_dataset`` entry point engages the real backends and writes
the label files JAX's script writes.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from creste_public_tpu.preprocessing import features as jfeatures
from creste_public_tpu.preprocessing import video_tracking as jvt
from creste_public_tpu_torch.preprocessing import features
from creste_public_tpu_torch.preprocessing import video_tracking as vt
from tests.test_real_backends import (  # noqa: F401 (fixtures)
    _img,
    _tiny_tree,
    tiny_dinov2,
    tiny_gdino,
    tiny_sam,
)
from tests.test_torch_step_helpers import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
RTOL = 1e-5
LOADERS = ("try_load_detector", "try_load_mask_predictor",
           "try_load_auto_mask_generator")


@pytest.fixture
def tiny_env(tiny_sam, tiny_gdino, monkeypatch):
    monkeypatch.setenv("CRESTE_SAM_MODEL", tiny_sam)
    monkeypatch.setenv("CRESTE_GROUNDING_DINO", tiny_gdino)
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")


def test_loaders_put_models_on_the_device(tiny_env, monkeypatch):
    """Each loader builds its wrapper on the device given: the model is
    moved there (``Module.to`` called with it), every parameter sits
    there, and the wrapper keeps it for the inputs."""
    moved = []
    to = torch.nn.Module.to

    def spy(self, *args, **kwargs):
        moved.append((type(self).__name__, args, kwargs))
        return to(self, *args, **kwargs)

    monkeypatch.setattr(torch.nn.Module, "to", spy)
    for name in LOADERS:
        moved.clear()
        w = getattr(vt, name)(device="cpu")
        assert w is not None, name
        assert w.device == CPU
        assert (type(w.model).__name__, (CPU,), {}) in moved, (name, moved)
        assert {p.device for p in w.model.parameters()} == {CPU}


def test_loaders_refuse_cuda_without_it(tiny_env, monkeypatch):
    """Asked for the card on a machine without one, the loaders and the
    wrappers raise: none loads the model onto the CPU instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in LOADERS:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            getattr(vt, name)()
    for cls in (vt.HFSamMaskPredictor, vt.HFSamAutoMaskGenerator):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cls(model_id=os.environ["CRESTE_SAM_MODEL"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        vt.GroundingDinoDetector(model_id=os.environ["CRESTE_GROUNDING_DINO"])


def test_no_weights_returns_none_without_importing_transformers(tmp_path):
    """Without weights on disk the loaders return None and ``auto``
    extracts with the random projection, and transformers is never
    imported (run in a fresh process, where nothing imported it yet)."""
    code = (
        "import sys, torch\n"
        "from creste_public_tpu_torch.preprocessing import features as f\n"
        "from creste_public_tpu_torch.preprocessing import "
        "video_tracking as vt\n"
        "assert vt.try_load_detector(device='cpu') is None\n"
        "assert vt.try_load_mask_predictor(device='cpu') is None\n"
        "assert vt.try_load_auto_mask_generator(device='cpu') is None\n"
        "e = f.build_extractor('auto', device='cpu')\n"
        "assert isinstance(e, f.RandomProjectionExtractor)\n"
        "assert 'transformers' not in sys.modules, 'transformers imported'\n"
    )
    env = dict(os.environ, HF_HUB_OFFLINE="1", HF_HOME=str(tmp_path / "hf"),
               CRESTE_SAM_MODEL=str(tmp_path / "none"),
               CRESTE_GROUNDING_DINO="IDEA-Research/grounding-dino-base",
               CRESTE_DINOV2_MODEL=str(tmp_path / "none"))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=root, timeout=120)


def test_gdino_detector_matches_jax(tiny_gdino):
    kw = dict(model_id=tiny_gdino, box_threshold=0.0, text_threshold=0.0)
    img = _img()
    boxes, cls = vt.GroundingDinoDetector(device="cpu", **kw).detect(img)
    want_boxes, want_cls = jvt.GroundingDinoDetector(**kw).detect(img)
    np.testing.assert_array_equal(boxes, want_boxes)
    np.testing.assert_array_equal(cls, want_cls)


def test_sam_predictor_matches_jax(tiny_sam):
    img = _img()
    boxes = np.array([[5, 5, 30, 30], [10, 2, 40, 40]], np.float64)
    got = vt.HFSamMaskPredictor(model_id=tiny_sam,
                                device="cpu").predict(img, boxes)
    want = jvt.HFSamMaskPredictor(model_id=tiny_sam).predict(img, boxes)
    assert got.shape == (2, *img.shape[:2]) and got.dtype == bool
    np.testing.assert_array_equal(got, want)


def test_auto_mask_generator_matches_jax(tiny_sam):
    kw = dict(model_id=tiny_sam, points_per_side=4, pred_iou_thresh=-1e9)
    img = _img()
    masks, scores = vt.HFSamAutoMaskGenerator(device="cpu",
                                              **kw).generate(img)
    want_masks, want_scores = jvt.HFSamAutoMaskGenerator(**kw).generate(img)
    np.testing.assert_array_equal(masks, want_masks)
    np.testing.assert_array_equal(scores, want_scores)


def test_dinov2_extractor_matches_jax(tiny_dinov2, monkeypatch):
    monkeypatch.setenv("CRESTE_DINOV2_MODEL", tiny_dinov2)
    ex = features.build_extractor("auto", stride=7, device="cpu")
    assert isinstance(ex, features.DinoV2Extractor) and ex.device == CPU
    assert {p.device for p in ex.model.parameters()} == {CPU}
    imgs = np.random.default_rng(0).uniform(
        0, 1, (1, 56, 70, 3)).astype(np.float32)
    got = ex(imgs)
    want = jfeatures.build_extractor("dinov2", stride=7)(imgs)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=RTOL * np.abs(want).max())


@pytest.mark.parametrize("mode", ["static", "dynamic"])
def test_create_sam_dataset_engages_real_backends(mode, tiny_env, tmp_path,
                                                  capsys):
    """The entry point with ``--device cpu`` picks the real backends (no
    fallback warning) and writes the files JAX's script writes."""
    from creste_public_tpu_torch.preprocessing.create_sam_dataset import main
    from scripts.preprocessing import create_sam_dataset as jcli

    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    root = _tiny_tree(tmp_path / "port")
    jroot = _tiny_tree(tmp_path / "jax")
    main(["--root", root, "--seqs", "0", "--mode", mode, "--step", "2",
          "--device", "cpu"])
    assert "weights unavailable" not in capsys.readouterr().out
    args = argparse.Namespace(root=jroot, cam="cam0", step=2)
    (jcli.run_static if mode == "static" else jcli.run_dynamic)(args, "0")
    family = "2d_sam" if mode == "static" else "2d_sam_dynamic"
    for i in range(3):
        rel = os.path.join(family, "cam0", "0", f"{i}.npy")
        got = np.load(os.path.join(root, rel))
        assert got.shape[:2] == (48, 56) and got.dtype == np.uint16
        np.testing.assert_array_equal(got, np.load(os.path.join(jroot, rel)))
