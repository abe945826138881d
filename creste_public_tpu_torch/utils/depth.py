"""Depth discretisation: the softmax-expectation metric depth.

Counterpart of ``creste_public_tpu/utils/depth.py:75-95``
(``metric_depth_from_logits``): bin values are
``linspace(depth_min, depth_max, num_bins)`` whatever the binning mode.
"""
from __future__ import annotations

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
