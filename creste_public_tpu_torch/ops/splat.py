"""Bilinear point -> BEV-grid splatting (the lift-splat core).

Counterpart of ``creste_public_tpu/ops/splat.py`` (reference ``splat_soft``,
splat_projection.py:262-354). Semantics:

  * each point votes into its 4 neighbouring voxels with bilinear weights;
  * a corner outside the grid gets weight 0 and is clamped to voxel 0;
  * modes 'sum', 'mean' (sum / clamp(density, min_weight)) and 'max' (max
    of the weighted features against a zero grid, so floored at 0).

Plain PyTorch scatter (``index_add_`` / ``scatter_reduce_``), with the
density folded in as channel F+1 so that mean and sum take one scatter. On
CUDA ``index_add_`` of floats is atomic: the order of the additions, and
so the last bits of a voxel's sum, vary from run to run.
"""
from __future__ import annotations

import torch


def splat_bilinear(
    xy: torch.Tensor,
    feats: torch.Tensor,
    grid_hw: tuple[int, int],
    mode: str = "mean",
    min_weight: float = 1.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Splat features at fractional 2-D voxel coords onto a dense grid.

    Args:
      xy: [B, P, 2] fractional voxel coords; xy[..., 0] is the column (x,
        bounded by W), xy[..., 1] the row (y, bounded by H).
      feats: [B, P, F] per-point features (invalid points already carry
        zero features).
      grid_hw: (H, W).
      mode: 'mean' | 'sum' | 'max'.
      min_weight: floor of the density divisor in 'mean' mode.

    Returns:
      volume_features [B, H*W, F] and volume_densities [B, H*W].
    """
    if mode not in ("mean", "sum", "max"):
        raise ValueError(f"Unknown splat scatter mode: {mode}")
    H, W = grid_hw
    B, P, F = feats.shape
    n_vox = H * W
    out_dtype = feats.dtype

    xy = xy.float()
    xy0 = torch.floor(xy)
    r = xy - xy0
    x0 = xy0[..., 0].long()
    y0 = xy0[..., 1].long()
    rx, ry = r[..., 0], r[..., 1]

    idxs, ws = [], []
    for xdiff in (0, 1):
        x_ = x0 + xdiff
        wx = (1 - xdiff) + (2 * xdiff - 1) * rx
        for ydiff in (0, 1):
            y_ = y0 + ydiff
            wy = (1 - ydiff) + (2 * ydiff - 1) * ry
            valid = (x_ >= 0) & (x_ < W) & (y_ >= 0) & (y_ < H)
            idxs.append(torch.where(valid, y_ * W + x_, 0))
            ws.append(torch.where(valid, wx * wy, 0.0))

    idx4 = torch.cat(idxs, dim=1)  # [B, 4P]
    w4 = torch.cat(ws, dim=1)  # [B, 4P]
    flat = (torch.arange(B, device=idx4.device)[:, None] * n_vox
            + idx4).reshape(-1)
    upd = w4[..., None] * feats.float().repeat(1, 4, 1)  # [B, 4P, F]

    if mode == "max":
        densities = torch.zeros(B * n_vox, device=w4.device).index_add_(
            0, flat, w4.reshape(-1)).reshape(B, n_vox)
        features = torch.zeros(B * n_vox, F, device=w4.device).scatter_reduce_(
            0, flat[:, None].expand(-1, F), upd.reshape(-1, F), reduce="amax",
            include_self=True).reshape(B, n_vox, F)
    else:
        upd = torch.cat([upd, w4[..., None]], dim=-1)  # [B, 4P, F+1]
        acc = torch.zeros(B * n_vox, F + 1, device=w4.device).index_add_(
            0, flat, upd.reshape(-1, F + 1)).reshape(B, n_vox, F + 1)
        features, densities = acc[..., :F], acc[..., F]
        if mode == "mean":
            features = features / densities.clamp(min=min_weight)[..., None]
    return features.to(out_dtype), densities


def splat_to_bev(
    xy: torch.Tensor,
    feats: torch.Tensor,
    grid_hw: tuple[int, int],
    mode: str = "mean",
    min_weight: float = 1.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``splat_bilinear`` returning NHWC grids: bev_features [B, H, W, F]
    and bev_densities [B, H, W, 1]."""
    H, W = grid_hw
    f, d = splat_bilinear(xy, feats, grid_hw, mode, min_weight)
    B, _, F = f.shape
    return f.reshape(B, H, W, F), d.reshape(B, H, W, 1)
