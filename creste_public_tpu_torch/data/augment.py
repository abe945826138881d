"""Training-time data augmentation (host-side numpy).

A copy of ``creste_public_tpu/data/augment.py``, bit-equal to it for the
same ``np.random.Generator`` (reference creste/utils/train_utils.py:30-182):

  * ``ImageAugmentation``: kornia's ColorJitter (brightness, contrast,
    saturation, hue) and RandomGamma, with a ``keep_aug`` mode that reuses
    the previous draw across the views of one sample
    (codapefree_dataloader.py:861).
  * ``DepthAugmentation``: LiDAR dropout (random point masking), a
    simulated camera-LiDAR miscalibration (a small random rigid warp of the
    sparse depth map) and Gaussian depth noise.

Each sample draws from a generator of its own (the loader's
``_sample_rng``), so the augmentation does not depend on which worker
thread or process fetched the sample.
"""
from __future__ import annotations

import numpy as np


def _rgb_to_hsv(rgb: np.ndarray) -> np.ndarray:
    maxc = rgb.max(-1)
    minc = rgb.min(-1)
    v = maxc
    d = maxc - minc
    s = np.where(maxc > 0, d / np.maximum(maxc, 1e-12), 0.0)
    rc = (maxc - rgb[..., 0]) / np.maximum(d, 1e-12)
    gc = (maxc - rgb[..., 1]) / np.maximum(d, 1e-12)
    bc = (maxc - rgb[..., 2]) / np.maximum(d, 1e-12)
    h = np.where(
        rgb[..., 0] == maxc, bc - gc,
        np.where(rgb[..., 1] == maxc, 2.0 + rc - bc, 4.0 + gc - rc),
    )
    h = (h / 6.0) % 1.0
    h = np.where(d == 0, 0.0, h)
    return np.stack([h, s, v], -1)


def _hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = np.floor(h * 6.0).astype(int) % 6
    f = h * 6.0 - np.floor(h * 6.0)
    p = v * (1 - s)
    q = v * (1 - s * f)
    t = v * (1 - s * (1 - f))
    table = np.stack(
        [np.stack([v, t, p], -1), np.stack([q, v, p], -1),
         np.stack([p, v, t], -1), np.stack([p, q, v], -1),
         np.stack([t, p, v], -1), np.stack([v, p, q], -1)], 0,
    )
    return np.take_along_axis(table, i[None, ..., None], axis=0)[0]


class ImageAugmentation:
    """ColorJitter + gamma with redrawable/shareable parameters."""

    def __init__(self, brightness=0.2, contrast=0.2, saturation=0.2,
                 hue=0.05, gamma=(0.8, 1.2), gamma_p=0.5):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue
        self.gamma = gamma
        self.gamma_p = gamma_p
        self._params = None

    def draw(self, rng: np.random.Generator) -> dict:
        p = {
            "brightness": rng.uniform(max(0, 1 - self.brightness),
                                      1 + self.brightness),
            "contrast": rng.uniform(max(0, 1 - self.contrast),
                                    1 + self.contrast),
            "saturation": rng.uniform(max(0, 1 - self.saturation),
                                      1 + self.saturation),
            "hue": rng.uniform(-self.hue, self.hue),
            "gamma": (
                rng.uniform(*self.gamma)
                if self.gamma and rng.uniform() < self.gamma_p else 1.0
            ),
        }
        self._params = p
        return p

    def __call__(self, rgb: np.ndarray, rng: np.random.Generator,
                 keep_aug: bool = False) -> np.ndarray:
        """rgb [H, W, 3] in [0, 1]."""
        p = self._params if (keep_aug and self._params) else self.draw(rng)
        out = rgb * p["brightness"]
        mean = out.mean()
        out = (out - mean) * p["contrast"] + mean
        if p["saturation"] != 1.0 or p["hue"] != 0.0:
            hsv = _rgb_to_hsv(np.clip(out, 0, 1))
            hsv[..., 1] = np.clip(hsv[..., 1] * p["saturation"], 0, 1)
            hsv[..., 0] = (hsv[..., 0] + p["hue"]) % 1.0
            out = _hsv_to_rgb(hsv)
        out = np.clip(out, 0.0, 1.0)
        if p["gamma"] != 1.0:
            out = out ** p["gamma"]
        return out.astype(np.float32)


class DepthAugmentation:
    """LiDAR dropout + miscalibration warp + Gaussian noise
    (train_utils.py:112-182)."""

    def __init__(self, dropout_prob=0.1, calib_error_std=(0.02, 0.02, 0.01),
                 depth_noise_std=0.2):
        self.dropout_prob = dropout_prob
        self.calib_error_std = calib_error_std
        self.depth_noise_std = depth_noise_std

    def _miscalibrate(self, depth: np.ndarray, rng) -> np.ndarray:
        H, W = depth.shape
        tx, ty, rot = rng.normal(0.0, self.calib_error_std)
        c, s = np.cos(rot), np.sin(rot)
        cy, cx = H / 2, W / 2
        ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
        # inverse-map output pixels to source coords
        x0 = xs - cx - tx
        y0 = ys - cy - ty
        sx = (c * x0 + s * y0 + cx).round().astype(int)
        sy = (-s * x0 + c * y0 + cy).round().astype(int)
        ok = (sx >= 0) & (sx < W) & (sy >= 0) & (sy < H)
        out = np.zeros_like(depth)
        out[ok] = depth[sy[ok], sx[ok]]
        return out

    def __call__(self, depth: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        """depth [H, W] in mm (0 = invalid)."""
        valid = depth > 0
        drop = rng.uniform(size=depth.shape) > self.dropout_prob
        out = depth * drop
        out = self._miscalibrate(out, rng)
        noise = rng.normal(0.0, self.depth_noise_std * 1000.0, depth.shape)
        out = np.where(out > 0, np.maximum(out + noise, 0.0), 0.0)
        return out.astype(np.float32)


def augment_sample(
    sample: dict, rng: np.random.Generator,
    image_aug: ImageAugmentation | None = None,
    depth_aug: DepthAugmentation | None = None,
) -> dict:
    """Apply image+depth augs to the 'image' tensor of a sample dict
    (keep_aug shared across views, codapefree_dataloader.py:861)."""
    image_aug = image_aug or ImageAugmentation()
    depth_aug = depth_aug or DepthAugmentation()
    out = dict(sample)
    img = sample["image"].copy()  # [V, H, W, 4]
    for v in range(img.shape[0]):
        img[v, ..., :3] = image_aug(img[v, ..., :3], rng, keep_aug=v > 0)
        img[v, ..., 3] = depth_aug(img[v, ..., 3], rng)
    out["image"] = img
    return out
