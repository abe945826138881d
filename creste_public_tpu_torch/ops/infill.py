"""Inverse-distance-weighted (IDW) sparse-depth densification.

Counterpart of ``creste_public_tpu/ops/infill.py`` (reference
creste/utils/infill.py:40-75 ``dense_map``): each output pixel averages the
sparse depths in a window, weighted by 1/distance to each sample's
subpixel location. Three [H, W] planes (depth and the subpixel x/y
residuals) are rolled over the window offsets and accumulated, one
elementwise pass per offset. The reference's quirks are kept, as the
labels on disk were made with them: the window is asymmetric (offsets
-g-1 .. g-1, 81 of them at g=4), the distance pairs the column residual
with the row offset, and only the [g+1 : -g] interior is written.
"""
from __future__ import annotations

import torch


def idw_densify(uvd: torch.Tensor | None = None,
                img_hw: tuple[int, int] | None = None,
                depth: torch.Tensor | None = None,
                window: int = 4) -> torch.Tensor:
    """Densify sparse depth samples with windowed IDW.

    Two call forms:
      idw_densify(uvd=[N, 3] (u, v, d) samples, img_hw=(H, W))   point form
      idw_densify(depth=[H, W] image, window=...)                grid form
        (integer-pixel samples; nonzero = valid)

    In the point form a pixel hit by several samples keeps the last one
    (the reference's fancy assignment): the winner is a scatter-max of the
    sample index, so depth and both residuals come from the same sample.

    Returns [H, W] f32 dense depth on the input's device, 0 outside the
    interior frame.
    """
    g = window
    if depth is not None:
        d_plane = depth.float()
        H, W = d_plane.shape
        dev = d_plane.device
        rx = torch.zeros((H, W), dtype=torch.float32, device=dev)
        ry = torch.zeros_like(rx)
    else:
        if img_hw is None:
            raise ValueError("the point form needs img_hw")
        H, W = img_hw
        dev = uvd.device
        u, v, d = uvd[:, 0], uvd[:, 1], uvd[:, 2]
        ui = u.clamp(-2.0, 2.0 ** 30).to(torch.int32)
        vi = v.clamp(-2.0, 2.0 ** 30).to(torch.int32)
        valid = (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H) & (d > 0)
        idx = torch.where(valid, vi.long() * W + ui.long(),
                          torch.zeros_like(ui, dtype=torch.long))
        n = uvd.shape[0]
        rank = torch.arange(n, dtype=torch.long, device=dev)
        winner = torch.full((H * W,), -1, dtype=torch.long, device=dev)
        winner.scatter_reduce_(0, idx, torch.where(valid, rank, -1), "amax")
        got = winner >= 0
        w = winner.clamp(0, max(n - 1, 0))
        zero = torch.zeros((), dtype=uvd.dtype, device=dev)
        d_plane = torch.where(got, d[w], zero).reshape(H, W).float()
        rx = torch.where(got, (u - ui.to(u.dtype))[w], zero).reshape(H, W)
        ry = torch.where(got, (v - vi.to(v.dtype))[w], zero).reshape(H, W)
        rx, ry = rx.float(), ry.float()
    has = d_plane > 0

    num = torch.zeros((H, W), dtype=torch.float32, device=dev)
    den = torch.zeros_like(num)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    for dy in range(-g - 1, g):
        for dx in range(-g - 1, g):
            # position p sees the sample at p + (dy, dx)
            shift = (-dy, -dx)
            sd = torch.roll(d_plane, shift, dims=(0, 1))
            sx = torch.roll(rx, shift, dims=(0, 1))
            sy = torch.roll(ry, shift, dims=(0, 1))
            sv = torch.roll(has, shift, dims=(0, 1))
            ox = dy + sx  # column residual + row offset (reference quirk)
            oy = dx + sy
            dist = torch.sqrt(ox * ox + oy * oy)
            w = torch.where(sv, 1.0 / torch.clamp(dist, min=1e-6), zero)
            num = num + w * sd
            den = den + w
    out = num / (den + 1e-12)
    ys = torch.arange(H, device=dev)[:, None]
    xs = torch.arange(W, device=dev)[None, :]
    interior = (ys >= g + 1) & (ys < H - g) & (xs >= g + 1) & (xs < W - g)
    return torch.where(interior, out, zero)
