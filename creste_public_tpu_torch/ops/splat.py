"""Bilinear point -> BEV-grid splatting (the lift-splat core).

Counterpart of ``creste_public_tpu/ops/splat.py`` (reference ``splat_soft``,
splat_projection.py:262-354). Semantics:

  * each point votes into its 4 neighbouring voxels with bilinear weights;
  * a corner outside the grid gets weight 0 and is clamped to voxel 0;
  * modes 'sum', 'mean' (sum / clamp(density, min_weight)) and 'max' (max
    of the weighted features against a zero grid, so floored at 0).

The density is folded in as channel F+1, so that mean and sum take one
scatter (``splat_sums``; ``finish_splat`` divides, so that sums made
apart, on the ranks of a width-sharded frame, can be added first;
``splat_max``'s grids combine by their maximum). The sums are the operator
``creste::splat_sums`` (``ops/splat_kernel.py``): on the card the
hand-written kernel of ``csrc/splat.cu``, which adds each voxel's votes in
their order, equal to the bit to ``splat_sums_plain`` (``index_add_``) run
on the CPU and the same on every run; on the CPU ``splat_sums_plain``
itself. A 'max' splat's features stay on ``scatter_reduce_(amax)``, whose
result does not depend on order; its densities are the operator's with no
feature channel.
"""
from __future__ import annotations

import torch


def _corners(xy: torch.Tensor, grid_hw: tuple[int, int]
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The flat voxel index [B * 4P] (batch element b's voxels from
    ``b * H * W``) and the bilinear weight [B, 4P] of each point's four
    corners, corner by corner."""
    H, W = grid_hw
    B = xy.shape[0]
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
    flat = (torch.arange(B, device=idx4.device)[:, None] * (H * W)
            + idx4).reshape(-1)
    return flat, w4


def votes(xy: torch.Tensor, feats: torch.Tensor, grid_hw: tuple[int, int]
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Each point's four votes: the flat voxel index [B * 4P] and the
    update [B, 4P, F+1] f32 (the weighted features, then the weight),
    corner by corner."""
    flat, w4 = _corners(xy, grid_hw)
    upd = w4[..., None] * feats.float().repeat(1, 4, 1)  # [B, 4P, F]
    return flat, torch.cat([upd, w4[..., None]], dim=-1)


def splat_sums_plain(xy: torch.Tensor, feats: torch.Tensor,
                     grid_hw: tuple[int, int]) -> torch.Tensor:
    """``splat_sums`` in plain PyTorch (``index_add_`` of ``votes``): the
    operator's CPU implementation and the kernel's yardstick. On the CPU
    ``index_add_`` adds a voxel's votes in index order; on the card it
    adds with float atomics, in an order that varies from run to run."""
    H, W = grid_hw
    B, P, F = feats.shape
    flat, upd = votes(xy, feats, grid_hw)
    return torch.zeros(B * H * W, F + 1, device=upd.device).index_add_(
        0, flat, upd.reshape(-1, F + 1)).reshape(B, H * W, F + 1)


def splat_sums(xy: torch.Tensor, feats: torch.Tensor,
               grid_hw: tuple[int, int]) -> torch.Tensor:
    """The sums a 'sum' or 'mean' splat divides: [B, H*W, F+1] f32, each
    voxel's bilinearly weighted feature sums, then its density (the sum of
    the weights), by the operator ``creste::splat_sums`` (xy and feats read
    in f32). Sums of disjoint point sets add (a frame split across ranks);
    ``finish_splat`` makes the grids."""
    H, W = grid_hw
    return torch.ops.creste.splat_sums(xy.float().contiguous(),
                                       feats.float().contiguous(), H, W)


def finish_splat(acc: torch.Tensor, mode: str, min_weight: float,
                 out_dtype: torch.dtype
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """``splat_sums``' [B, H*W, F+1] -> volume_features [B, H*W, F] (the
    sums, or in 'mean' mode the sums over clamp(density, min_weight)) in
    ``out_dtype`` and volume_densities [B, H*W]."""
    F = acc.shape[-1] - 1
    features, densities = acc[..., :F], acc[..., F]
    if mode == "mean":
        features = features / densities.clamp(min=min_weight)[..., None]
    return features.to(out_dtype), densities


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
    if mode != "max":
        return finish_splat(splat_sums(xy, feats, grid_hw), mode, min_weight,
                            feats.dtype)
    features, densities = splat_max(xy, feats, grid_hw)
    return features.to(feats.dtype), densities


def splat_max(xy: torch.Tensor, feats: torch.Tensor,
              grid_hw: tuple[int, int]
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """A 'max' splat before its cast: [B, H*W, F] f32, each voxel's
    largest bilinearly weighted feature over a zero grid
    (``scatter_reduce_(amax, include_self=True)``), and its density
    [B, H*W] (``splat_sums`` with no feature channel). The maxima of
    disjoint point sets combine by their maximum (every grid starts at the
    same zeros), their densities by their sum."""
    H, W = grid_hw
    B, P, F = feats.shape
    n_vox = H * W
    flat, w4 = _corners(xy, grid_hw)
    upd = w4[..., None] * feats.float().repeat(1, 4, 1)  # [B, 4P, F]
    xy32 = xy.float()
    densities = splat_sums(xy32, xy32.new_empty((B, P, 0)), grid_hw)[..., 0]
    features = torch.zeros(B * n_vox, F, device=w4.device).scatter_reduce_(
        0, flat[:, None].expand(-1, F), upd.reshape(-1, F), reduce="amax",
        include_self=True).reshape(B, n_vox, F)
    return features, densities


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


# registers creste::splat_sums (it imports this module's plain version)
from creste_public_tpu_torch.ops import splat_kernel  # noqa: E402,F401
