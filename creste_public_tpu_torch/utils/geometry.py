"""Camera / LiDAR / BEV geometry of the deployment graph.

Counterpart of ``creste_public_tpu/utils/geometry.py:21-122``. Channels-last
layout, as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch


def backproject_depth(depth: torch.Tensor, p2p: torch.Tensor) -> torch.Tensor:
    """Lift a depth image into LiDAR-frame points.

    Homogeneous pixel rays [u*d, v*d, d, 1] are mapped by the 4x4
    pixel-to-point matrix ``p2p``.

    Args:
      depth: [..., H, W] metric depth (metres).
      p2p:   [..., 4, 4] pixel->point homogeneous transform.

    Returns:
      xyz: [..., H, W, 3].
    """
    H, W = depth.shape[-2:]
    d = depth.float()
    v, u = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=d.device),
        torch.arange(W, dtype=torch.float32, device=d.device),
        indexing="ij",
    )
    pix = torch.stack([u * d, v * d, d, torch.ones_like(d)], dim=-1)
    xyz = torch.einsum("...ij,...hwj->...hwi", p2p.float(), pix)
    return xyz[..., :3]


def lidar_to_map_matrix(min_bound: np.ndarray) -> np.ndarray:
    """Fixed LiDAR->map-frame SE(3): axis swap + recentre to the grid origin
    (row0 = -y - xmin, row1 = -x - ymin, row2 = -z - zmin)."""
    xmin, ymin, zmin = (float(min_bound[0]), float(min_bound[1]),
                        float(min_bound[2]))
    return np.array(
        [
            [0.0, -1.0, 0.0, -xmin],
            [-1.0, 0.0, 0.0, -ymin],
            [0.0, 0.0, -1.0, -zmin],
            [0.0, 0.0, 0.0, 1.0],
        ],
        dtype=np.float32,
    )


def points_to_voxels(points: torch.Tensor, lidar2map: torch.Tensor,
                     voxel_size_xy: torch.Tensor) -> torch.Tensor:
    """Fractional 2-D voxel coordinates [..., 2] of LiDAR-frame points
    [..., 3] (not floored: the splat weights them bilinearly)."""
    R = lidar2map[:2, :3]
    t = lidar2map[:2, 3]
    xy = torch.einsum("ij,...j->...i", R, points) + t
    return xy / voxel_size_xy


def point_in_range_mask(points: torch.Tensor, min_bound: torch.Tensor,
                        max_bound: torch.Tensor) -> torch.Tensor:
    """Boolean mask of points inside [min_bound, max_bound) on every axis."""
    return ((points < max_bound) & (points >= min_bound)).all(dim=-1)


def create_trapezoidal_fov_mask(
    H: int,
    W: int,
    fov_top_angle: float = 50.0,
    fov_bottom_angle: float = 40.0,
    near: float = 10.0,
    far: float = 50.0,
) -> np.ndarray:
    """North-facing trapezoidal field-of-view mask (NumPy, host constant).
    The angular spread goes linearly from ``fov_top_angle`` at ``near`` to
    ``fov_bottom_angle`` at ``far``."""
    y, x = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    cx, cy = W / 2.0, H / 2.0
    dist = np.sqrt((x - cx) ** 2 + (y - cy) ** 2)
    ang = np.arctan2(x - cx, cy - y) * 180.0 / np.pi
    ang = np.where(ang < -180.0, ang + 360.0, ang)

    spread_top = np.full_like(dist, fov_top_angle / 2.0)
    spread_bot = np.full_like(dist, fov_bottom_angle / 2.0)
    frac = (dist - near) / (far - near)
    spread = np.where(
        dist <= near,
        spread_top,
        np.where(dist >= far, spread_bot,
                 spread_top + (spread_bot - spread_top) * frac),
    )
    return (dist >= near) & (dist <= far) & (np.abs(ang) <= spread)
