"""Expert-trajectory rasterisation onto the BEV reward grid.

Counterpart of ``creste_public_tpu/ops/rasterize.py``: each segment between
consecutive poses is sampled at ``max_steps`` evenly spaced points (a fixed
bound in place of the reference's data-dependent ``ceil`` of the segment
length), the final pose is appended, ones are scattered onto the grid and
the visit counts are clamped to 1.
"""
from __future__ import annotations

import torch


def rasterize_trajectory(xy: torch.Tensor, map_ds: float,
                         map_sz: tuple[int, int], max_steps: int = 32,
                         valid: torch.Tensor | None = None) -> torch.Tensor:
    """Binary visitation grid [B, H, W] f32 of trajectories xy [B, T, 2]
    (row, col in full-resolution BEV pixels, divided by ``map_ds``).
    ``valid`` [B, T] bool drops the segments with an invalid endpoint and
    an invalid final pose."""
    H, W = map_sz
    B, T, _ = xy.shape
    dev = xy.device
    pts = xy.float() / map_ds
    start, end = pts[:, :-1], pts[:, 1:]
    # jnp.linspace(0, 1, n): iota * (1 / (n - 1)) in f32, then exactly 1
    t = torch.arange(max_steps - 1, dtype=torch.float32, device=dev) * (
        torch.tensor(1.0) / (max_steps - 1)).to(dev)
    t = torch.cat([t, torch.ones(1, device=dev)]).reshape(1, 1, -1, 1)
    interp = start[:, :, None, :] + t * (end - start)[:, :, None, :]
    interp = torch.cat([interp.reshape(B, -1, 2), pts[:, -1:]], dim=1)
    x = interp[..., 0].clamp(0, H - 1).long()
    y = interp[..., 1].clamp(0, W - 1).long()
    lin = x * W + y
    if valid is not None:
        valid = valid.bool()
        seg = (valid[:, :-1] & valid[:, 1:])[:, :, None].expand(
            B, T - 1, max_steps).reshape(B, -1)
        weights = torch.cat([seg, valid[:, -1:]], dim=1).float()
    else:
        weights = torch.ones(lin.shape, device=dev)
    counts = torch.zeros(B, H * W, device=dev)
    counts.scatter_add_(1, lin, weights)
    return counts.clamp(max=1.0).reshape(B, H, W)
