"""The port's video instance tracking (``preprocessing/video_tracking.py``)
against the JAX package's: the instance registry, the weights-free
stand-ins and ``track_video`` on seeded blob videos (movers that cross,
deform, vanish behind an occluder and come back, a late newcomer). Every
per-frame (instance, class) map exact. (That the HF loaders return None
without weights is checked in tests/test_torch_preprocessing_chain.py,
whose process imports transformers anyway.)
"""
import numpy as np
import pytest

from creste_public_tpu.preprocessing import video_tracking as jvt
from creste_public_tpu_torch.preprocessing import video_tracking as vt


def blob_video(seed: int, n_frames: int = 10, hw=(48, 64)):
    rng = np.random.default_rng(seed)
    frames = []
    v = rng.integers(1, 4, (3, 2)) * rng.choice([-1, 1], (3, 2))
    p0 = rng.integers(12, 30, (3, 2))
    for f in range(n_frames):
        img = np.full((*hw, 3), 40.0, np.float32)
        for k in range(3):
            y, x = p0[k] + v[k] * f
            r = 3 + (f + k) % 3  # deforming
            img[max(y - r, 0):y + r, max(x - r, 0):x + r] = 230.0
        if 3 <= f <= 4:
            img[:, 20:30] = 40.0  # an occluder band
        if f >= 6:
            img[40:46, 4:12] = 255.0  # a newcomer
        img += rng.normal(size=img.shape) * 3
        frames.append(np.clip(img, 0, 255).astype(np.uint8))
    return frames


@pytest.mark.parametrize("seed, step", [(0, 1), (1, 3), (2, 4)])
def test_track_video_matches_jax(seed, step):
    frames = blob_video(seed)
    want = jvt.track_video(frames, jvt.FakeBlobDetector(),
                           jvt.FakeBoxMaskPredictor(),
                           jvt.TemplateMaskPropagator(), step=step)
    got = vt.track_video(frames, vt.FakeBlobDetector(),
                         vt.FakeBoxMaskPredictor(),
                         vt.TemplateMaskPropagator(), step=step)
    assert len(got) == len(want) == len(frames)
    for f, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype == np.uint16
        np.testing.assert_array_equal(g, w, err_msg=f"frame {f}")
    assert len(np.unique(np.stack(want)[..., 0])) >= 4


def test_registry_and_fakes_match_jax():
    rng = np.random.default_rng(3)
    masks = rng.uniform(size=(4, 16, 16)) > 0.6
    cls = np.array([1, 2, 3, 1])
    prev_masks = masks.copy()
    prev_masks[1] = ~prev_masks[1]
    regs = []
    for m in (vt, jvt):
        tracked = m.InstanceRegistry()
        tracked.add_detections(prev_masks, cls)
        det = m.InstanceRegistry()
        det.add_detections(masks, cls)
        count = det.reconcile(tracked, 7, iou_threshold=0.8)
        regs.append((count, det.to_maps((16, 16))))
    assert regs[0][0] == regs[1][0]
    np.testing.assert_array_equal(regs[0][1], regs[1][1])
    assert vt.mask_iou(masks[0], masks[1]) == jvt.mask_iou(masks[0], masks[1])
    img = blob_video(4)[0]
    boxes, c = vt.FakeBlobDetector().detect(img)
    jboxes, jc = jvt.FakeBlobDetector().detect(img)
    np.testing.assert_array_equal(boxes, jboxes)
    np.testing.assert_array_equal(c, jc)
    np.testing.assert_array_equal(vt.FakeBoxMaskPredictor().predict(img, boxes),
                                  jvt.FakeBoxMaskPredictor().predict(img,
                                                                     boxes))
    assert vt.grounding_dino_prompt() == jvt.grounding_dino_prompt()
