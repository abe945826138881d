"""Nearest resize and crop with ``F.interpolate(mode='nearest')`` semantics.

Counterpart of ``creste_public_tpu/utils/imageops.py``: the source index of
output ``o`` is ``floor(o * in / out)`` (for an integer 2x downscale the
even rows are kept), computed in double precision on the host.
"""
from __future__ import annotations

import numpy as np
import torch


def _nearest_idx(out_size: int, in_size: int) -> np.ndarray:
    idx = np.floor(np.arange(out_size) * (in_size / out_size)).astype(np.int64)
    return np.clip(idx, 0, in_size - 1)


def resize_nearest(x: torch.Tensor, out_hw: tuple[int, int],
                   spatial_axes: tuple[int, int] = (1, 2)) -> torch.Tensor:
    """Nearest resize of the two ``spatial_axes`` of ``x`` to ``out_hw``."""
    ha, wa = spatial_axes
    for axis, size in ((ha, out_hw[0]), (wa, out_hw[1])):
        idx = torch.from_numpy(_nearest_idx(size, x.shape[axis]))
        x = x.index_select(axis, idx.to(x.device))
    return x


def resize_and_crop(x: torch.Tensor, new_hw: tuple[int, int],
                    crop_bounds: tuple[int, int, int, int],
                    spatial_axes: tuple[int, int] = (1, 2)) -> torch.Tensor:
    """Nearest resize to ``new_hw``, then crop ``[y1:y2, x1:x2]`` (bounds
    past the edge clamp, as a Python slice does)."""
    y1, y2, x1, x2 = crop_bounds
    x = resize_nearest(x, new_hw, spatial_axes)
    ha, wa = spatial_axes
    x = x.narrow(ha, y1, min(y2, x.shape[ha]) - y1)
    return x.narrow(wa, x1, min(x2, x.shape[wa]) - x1)
