"""Depth discretisation: depth labels to bins, and the softmax-expectation
metric depth.

Counterpart of ``creste_public_tpu/utils/depth.py`` (``bin_depths`` and
``metric_depth_from_logits``). As in the reference, binning uses a bin size
of ``(max - min) / num_bins`` while the expectation's bin values are
``linspace(depth_min, depth_max, num_bins)`` whatever the binning mode.
"""
from __future__ import annotations

import math

import torch


def metric_depth_from_logits(
    depth_logits: torch.Tensor,
    mode: str,
    depth_min: float,
    depth_max: float,
    num_bins: int,
    bins_axis: int = -1,
) -> torch.Tensor:
    """Differentiable softmax-expectation depth from per-bin logits, in the
    unit of ``depth_min``/``depth_max`` (mm for the standard config).
    ``mode`` is accepted for signature parity; the expectation ignores it."""
    del mode
    probs = torch.softmax(depth_logits.float(), dim=bins_axis)
    values = torch.linspace(depth_min, depth_max, num_bins,
                            dtype=torch.float32, device=probs.device)
    shape = [1] * probs.ndim
    shape[bins_axis] = num_bins
    return (probs * values.reshape(shape)).sum(dim=bins_axis)


def bin_depths(depth_map: torch.Tensor, mode: str, depth_min: float,
               depth_max: float, num_bins: int,
               target: bool = False) -> torch.Tensor:
    """Depth -> (fractional) bin index, ``bin_depths`` of the JAX package
    (bin size ``(max - min) / num_bins`` for UD). With ``target=True``
    out-of-range and non-finite depths go to bin ``num_bins`` and the
    index is truncated to int32."""
    d = depth_map.float()
    if mode == "UD":
        bin_size = (depth_max - depth_min) / num_bins
        idx = (d - depth_min) / bin_size
    elif mode == "LID":
        bin_size = 2.0 * (depth_max - depth_min) / (num_bins * (1 + num_bins))
        idx = -0.5 + 0.5 * torch.sqrt(1.0 + 8.0 * (d - depth_min) / bin_size)
    elif mode == "SID":
        idx = (num_bins * (torch.log(1.0 + d) - math.log(1.0 + depth_min))
               / (math.log(1.0 + depth_max) - math.log(1.0 + depth_min)))
    else:
        raise NotImplementedError(mode)
    if target:
        invalid = (idx < 0) | (idx > num_bins) | ~torch.isfinite(idx)
        idx = torch.where(invalid, torch.full_like(idx, num_bins), idx)
        idx = idx.to(torch.int32)
    return idx
