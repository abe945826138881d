"""Differentiable affine BEV warp (the ConvGRU hidden state's pose warp).

Counterpart of ``creste_public_tpu/ops/warp.py`` (reference ``warp``,
creste/utils/utils.py:6-38, which calls kornia's ``warp_affine`` with
``align_corners=False`` and zero padding). kornia normalises pixels with the
align_corners=True rule and samples with the align_corners=False one, so
for an input affine ``M`` (a [B, 2, 3] pixel-space src -> dst motion) the
destination pixel p reads the source pixel, per axis of size S (W for x, H
for y),

    q = (p + 0.5) * (S - 1) / S,   r = M^{-1} [q, 1],   s = r * S / (S - 1) - 0.5

bilinearly with zeros outside. The chain folds into one [B, 2, 3] pixel
affine (``effective_pixel_affine``) and the four corners are gathered, as
the JAX package does. Maps are NHWC.
"""
from __future__ import annotations

import torch


def _hom(M: torch.Tensor) -> torch.Tensor:
    """[B, 2, 3] affine -> [B, 3, 3] homography."""
    bottom = torch.tensor([0.0, 0.0, 1.0], dtype=M.dtype,
                          device=M.device).expand(M.shape[0], 1, 3)
    return torch.cat([M, bottom], dim=1)


def effective_pixel_affine(M: torch.Tensor,
                           size: tuple[int, int]) -> torch.Tensor:
    """The destination -> source pixel affine [B, 2, 3] of the kornia
    align_corners=False chain (see the module docstring); ``size`` is
    (H, W)."""
    H, W = size
    sx, sy = (W - 1.0) / W, (H - 1.0) / H
    kw = dict(dtype=M.dtype, device=M.device)
    C1 = torch.tensor([[sx, 0.0, 0.5 * sx], [0.0, sy, 0.5 * sy],
                       [0.0, 0.0, 1.0]], **kw)
    C2 = torch.tensor([[1.0 / sx, 0.0, -0.5], [0.0, 1.0 / sy, -0.5],
                       [0.0, 0.0, 1.0]], **kw)
    Minv = torch.linalg.inv(_hom(M))
    return torch.einsum("ij,bjk,kl->bil", C2, Minv, C1)[:, :2]


def affine_warp(x: torch.Tensor, M: torch.Tensor, with_mask: bool = True
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Warp NHWC maps x [B, H, W, C] by the pixel-space affine M [B, 2, 3]
    (x = column, y = row; source content to destination positions).
    Returns (warped [B, H, W, C], mask [B, H, W] bool: the warped all-ones
    channel > 0.99, all True without ``with_mask``)."""
    return sample_affine(x, effective_pixel_affine(M.float(), x.shape[1:3]),
                         with_mask)


def sample_affine(x: torch.Tensor, A: torch.Tensor, with_mask: bool = True
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Bilinear sampling of x [B, H, W, C] at the source pixels the
    destination -> source affine A [B, 2, 3] gives, zeros outside, with the
    mask of ``affine_warp``."""
    B, H, W, C = x.shape
    dev = x.device
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev),
                            indexing="ij")

    def coeff(r, c):
        return A[:, r, c, None, None]

    sx = coeff(0, 0) * xs + coeff(0, 1) * ys + coeff(0, 2)
    sy = coeff(1, 0) * xs + coeff(1, 1) * ys + coeff(1, 2)
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = sx - x0, sy - y0

    flat = x.reshape(B, H * W, C)
    out = torch.zeros_like(x)
    ones_acc = torch.zeros((B, H, W), dtype=torch.float32, device=dev)
    for dy, dx, w in ((0, 0, (1 - fx) * (1 - fy)), (0, 1, fx * (1 - fy)),
                      (1, 0, (1 - fx) * fy), (1, 1, fx * fy)):
        cx, cy = x0 + dx, y0 + dy
        valid = (cx >= 0) & (cx <= W - 1) & (cy >= 0) & (cy <= H - 1)
        ci = torch.clamp(cx, 0, W - 1).to(torch.int64)
        cj = torch.clamp(cy, 0, H - 1).to(torch.int64)
        wv = torch.where(valid, w, torch.zeros_like(w))
        idx = (cj * W + ci).reshape(B, H * W, 1).expand(B, H * W, C)
        gathered = flat.gather(1, idx).reshape(B, H, W, C)
        out = out + gathered * wv[..., None].to(x.dtype)
        ones_acc = ones_acc + wv
    mask = (ones_acc > 0.99 if with_mask
            else torch.ones((B, H, W), dtype=torch.bool, device=dev))
    return out, mask


def se2_of_pose(pose: torch.Tensor) -> torch.Tensor:
    """The SE(2) 3x3 slice of a 4x4 pose: rows and columns (0, 1, 3)
    (reference convgru.py:282-283 ``_2d``)."""
    idx = torch.tensor([0, 1, 3], device=pose.device)
    return pose.index_select(-2, idx).index_select(-1, idx)


def relative_bev_affine(input_pose: torch.Tensor,
                        cell_pose: torch.Tensor) -> torch.Tensor:
    """``inv(_2d(input_pose)) @ _2d(cell_pose)`` -> [..., 2, 3]
    (reference convgru.py:285-287)."""
    M = torch.linalg.inv(se2_of_pose(input_pose)) @ se2_of_pose(cell_pose)
    return M[..., :2, :]


def noisify_affine(M: torch.Tensor, rot_noise: torch.Tensor,
                   trans_noise: torch.Tensor,
                   rotation_noise_scale: float = 0.01,
                   translation_noise_scale: float = 0.1) -> torch.Tensor:
    """[..., 2, 3] affines with a left-multiplied rotation jitter on the
    2x2 block and additive translation noise (reference convgru.py:212-233
    ``_noisify``); ``rot_noise`` [...] and ``trans_noise`` [..., 2] are
    standard-normal draws."""
    theta = rot_noise * rotation_noise_scale
    s, c = torch.sin(theta), torch.cos(theta)
    R = torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)],
                    dim=-2)
    rot = R @ M[..., :2, :2]
    trans = M[..., :, 2] + trans_noise * translation_noise_scale
    return torch.cat([rot, trans[..., None]], dim=-1)
