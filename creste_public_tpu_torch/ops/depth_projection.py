"""LiDAR -> camera depth-map projection (z-buffer) and scan accumulation.

Counterpart of ``creste_public_tpu/ops/depth_projection.py`` (reference
creste/utils/projection.py:64-146 ``pixels_to_depth`` and
scripts/preprocessing/build_dense_depth.py:224-366): points go through
``lidar2camrect``, pixels come from truncating ``cam / z`` toward zero,
in-bounds points with positive camera z reduce per pixel by max (the
reference's default: farthest wins) or min, and 0 means empty.

Pixels are truncated, so a point whose ``cam / z`` lands within an ulp of
a pixel edge moves to the next pixel if its f32 sums round otherwise. The
3x3 (and 4x4) products therefore run in XLA's order on the CPU: one fused
multiply-add chain per row, ``fma(z, p2, fma(y, p1, x * p0))``, then the
translation. A fused multiply-add is emulated in f64 (a product of two f32
numbers is exact there) and rounded to f32 once per step, so the card and
the CPU give the same bits and no matmul (TF32 on the card) is involved.
The per-pixel reduce is ``scatter_reduce_`` with ``amax``/``amin``, which
does not depend on the order of the atomics on the card.
"""
from __future__ import annotations

import numpy as np
import torch


def fma_affine(pts: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """``pts @ M[..., :3].T + M[..., 3]`` in f32 with XLA's rounding.

    pts [..., N, 3] and M [..., 3, 4] (batch dims broadcast, one matrix
    per leading index) -> [..., N, 3] f32. Each row is the chain
    ``fma(z, m2, fma(y, m1, x * m0)) + m3``, each step rounded to f32."""
    p = pts[..., :3].float().double()
    m = M[..., :3, :4].float().double()
    cols = []
    for i in range(3):
        a = (p[..., 0] * m[..., i, None, 0]).float().double()
        a = (p[..., 1] * m[..., i, None, 1] + a).float().double()
        a = (p[..., 2] * m[..., i, None, 2] + a).float()
        cols.append(a + m[..., i, None, 3].float())
    return torch.stack(cols, dim=-1)


def points_to_depth(points: torch.Tensor, lidar2camrect: torch.Tensor,
                    img_hw: tuple[int, int], reduce: str = "max"
                    ) -> torch.Tensor:
    """Project a LiDAR point cloud to a sparse depth image.

    Args:
      points: [N, 3+] LiDAR-frame points (extra columns ignored).
      lidar2camrect: [3, 4] or [4, 4] rectified-camera projection.
      img_hw: (H, W) output size.
      reduce: 'max' (reference default: farthest wins) or 'min' (nearest).

    Returns [H, W] f32 depth on ``points``' device; 0 = no point.
    """
    H, W = img_hw
    dev = points.device
    cam = fma_affine(points, lidar2camrect.to(dev))
    z = cam[:, 2]
    zs = torch.where(z == 0, torch.ones_like(z), z)
    uvf = cam[:, :2] / zs[:, None]
    # truncation toward zero; the clamp keeps the int32 cast defined and
    # every clamped value out of range
    uv = uvf.clamp(-2.0, 2.0 ** 30).to(torch.int32)
    u, v = uv[:, 0], uv[:, 1]
    valid = (z > 0) & (u >= 0) & (u < W) & (v >= 0) & (v < H)
    idx = torch.where(valid, v.long() * W + u.long(),
                      torch.zeros_like(u, dtype=torch.long))
    if reduce == "max":
        val = torch.where(valid, z, torch.zeros_like(z))
        flat = torch.zeros(H * W, dtype=torch.float32, device=dev)
        flat.scatter_reduce_(0, idx, val, "amax")
    elif reduce == "min":
        inf = torch.full_like(z, float("inf"))
        val = torch.where(valid, z, inf)
        flat = torch.full((H * W,), float("inf"), dtype=torch.float32,
                          device=dev)
        flat.scatter_reduce_(0, idx, val, "amin")
        flat = torch.where(torch.isinf(flat), torch.zeros_like(flat), flat)
    else:
        raise ValueError(f"Unknown reduce: {reduce}")
    return flat.reshape(H, W)


def relative_poses(poses, ref_pose) -> torch.Tensor:
    """ref_from_scan [S, 4, 4] f32 on the CPU, as the JAX package computes
    ``inv(ref_pose) @ poses`` in f32: both rounded to f32, the inverse an
    LU solve by the LAPACK that scipy and jaxlib share (``sgetrf`` and
    ``sgetrs``, bit-equal to JAX's; torch's own inverse differs in a last
    bit now and then), the product as XLA's fused multiply-add chain. The
    card's run takes the same host matrices."""
    from scipy.linalg import lu_factor, lu_solve

    ref = np.asarray(ref_pose, np.float32)
    inv = lu_solve(lu_factor(ref), np.eye(4, dtype=np.float32))
    a = torch.from_numpy(np.asarray(inv, np.float32)).double()
    b = torch.as_tensor(np.asarray(poses, np.float32)).double()
    acc = (a[None, :, 0, None] * b[:, None, 0, :]).float()
    for k in (1, 2, 3):
        acc = (a[None, :, k, None] * b[:, None, k, :] + acc.double()).float()
    return acc


def accumulate_scans(scans: torch.Tensor, poses, ref_pose) -> torch.Tensor:
    """Transform S scans [S, N, 3] into the reference frame and merge.

    ``poses`` [S, 4, 4] and ``ref_pose`` [4, 4] are world_from_lidar host
    arrays. Returns [S*N, 3] f32 points in the reference LiDAR
    frame on ``scans``' device (build_dense_depth.py:293
    ``transform_pc_frames``)."""
    rel = relative_poses(poses, ref_pose).to(scans.device)
    return fma_affine(scans[..., :3], rel[:, :3]).reshape(-1, 3)


def accumulate_and_project(scans: torch.Tensor, poses, ref_pose,
                           lidar2camrect: torch.Tensor,
                           img_hw: tuple[int, int], reduce: str = "max"
                           ) -> torch.Tensor:
    """Accumulate S scans into the reference frame and z-buffer them into
    an [H, W] depth image (the build_dense_depth hot path)."""
    merged = accumulate_scans(scans, poses, ref_pose)
    return points_to_depth(merged, lidar2camrect, img_hw, reduce)
