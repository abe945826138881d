"""Camera / LiDAR / BEV geometry of the deployment graph and the MDP solve.

Counterpart of ``creste_public_tpu/utils/geometry.py:21-122`` and
``:164-193``. Channels-last layout, as in the JAX package.

The host-side numpy helpers of the CODa reader follow, copies of the same
module's ``:125-163`` and ``:200-477``: the pose-warped and accumulated
FOV masks, the FOV-overlap search of the multiview samples, the
quaternion and pose conversions, and the SE(3) -> BEV SE(2) projection of
the expert path.
"""
from __future__ import annotations

import numpy as np
import torch


def backproject_depth(depth: torch.Tensor, p2p: torch.Tensor,
                      col0: int = 0) -> torch.Tensor:
    """Lift a depth image into LiDAR-frame points.

    Homogeneous pixel rays [u*d, v*d, d, 1] are mapped by the 4x4
    pixel-to-point matrix ``p2p``. Each coordinate is summed as XLA sums
    the JAX package's 4-term einsum, ``(a0 + a1) + (a2 + a3)`` with every
    product rounded on its own, so the points equal the reference's to the
    bit: a row whose height cancels to exactly 0 there (the horizon of a
    level camera) is exactly 0 here too, which keeps the z-embedding's
    ReLU on the same side of its kink (a matmul with fused multiply-adds
    leaves a residue of either sign).

    Args:
      depth: [..., H, W] metric depth (metres).
      p2p:   [..., 4, 4] pixel->point homogeneous transform.
      col0:  the image column of ``depth``'s first column (a strip of a
        wider image: ``u`` runs from ``col0``).

    Returns:
      xyz: [..., H, W, 3].
    """
    H, W = depth.shape[-2:]
    d = depth.float()
    v, u = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=d.device),
        torch.arange(col0, col0 + W, dtype=torch.float32, device=d.device),
        indexing="ij",
    )
    ud, vd = u * d, v * d
    p = p2p.float()[..., None, None, :, :]  # [..., 1, 1, 4, 4]
    return torch.stack([
        (ud * p[..., i, 0] + vd * p[..., i, 1])
        + (d * p[..., i, 2] + p[..., i, 3]) for i in range(3)], dim=-1)


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


def earliest_pose_in_fov(expert_xy: torch.Tensor,
                         fov_mask: torch.Tensor) -> torch.Tensor:
    """First expert pose (in time) inside the boolean FOV mask [H, W], per
    batch element of the integer grid coordinates ``expert_xy`` [B, T, 2]
    (row, col); (H - 1, W // 2) where no pose is inside. Returns [B, 2]."""
    B, T, _ = expert_xy.shape
    H, W = fov_mask.shape
    xs = expert_xy[..., 0].long().clamp(0, H - 1)
    ys = expert_xy[..., 1].long().clamp(0, W - 1)
    valid = fov_mask[xs, ys]
    t_idx = torch.arange(T, device=xs.device).expand(B, T)
    earliest = torch.where(valid, t_idx, T).amin(dim=1)
    none_valid = earliest == T
    earliest = torch.where(none_valid, 0, earliest)
    sel = torch.stack([xs.gather(1, earliest[:, None])[:, 0],
                       ys.gather(1, earliest[:, None])[:, 0]], dim=1)
    fallback = torch.tensor([H - 1, W // 2], device=xs.device)
    return torch.where(none_valid[:, None], fallback[None, :], sel)


def warp_bev_mask(mask: np.ndarray, pose: np.ndarray, voxel: float) -> np.ndarray:
    """Warp a BEV mask by a relative SE(3) pose (xy+yaw only).

    Reference: `_load_fov_mask` (codapefree_dataloader.py:691-709) warps the
    frustum mask by each pose via an SE(2) affine about the grid centre
    (train_utils.py:302-320 compute_transformation_fromSE3 + kornia warp).
    Nearest-neighbour inverse warp; cells sampling out of bounds are False.
    """
    H, W = mask.shape
    A = se3_to_bev_se2(pose, (H, W), voxel) @ np.linalg.inv(
        se3_to_bev_se2(np.eye(4), (H, W), voxel)
    )
    Ainv = np.linalg.inv(A)
    rr, cc = np.mgrid[0:H, 0:W].astype(np.float64)
    src = np.einsum(
        "ij,jhw->ihw", Ainv,
        np.stack([rr, cc, np.ones_like(rr)]),
    )
    sr = np.round(src[0]).astype(np.int64)
    sc = np.round(src[1]).astype(np.int64)
    ok = (sr >= 0) & (sr < H) & (sc >= 0) & (sc < W)
    out = np.zeros_like(mask, dtype=bool)
    out[ok] = mask[sr[ok], sc[ok]]
    return out


def accumulated_fov_mask(
    frustum: np.ndarray, rel_poses: np.ndarray, voxel: float
) -> np.ndarray:
    """Union of the frustum mask warped by each relative pose in the chain
    (the accumulate loop of codapefree_dataloader.py:697-709; the reference
    breaks after the first pose — pass a length-1 chain for that behaviour).
    """
    out = np.zeros_like(frustum, dtype=bool)
    for pose in rel_poses:
        out |= warp_bev_mask(frustum, pose, voxel)
    return out


def fov_sector_overlap(
    query_se2: np.ndarray,
    db_se2: np.ndarray,
    fov_deg: float = 70.0,
    view_dist: float = 12.8,
    max_dist: float = 19.2,
    grid: int = 64,
) -> np.ndarray:
    """Fractional overlap between the query camera's FOV sector and each
    database pose's sector.

    Parity target: creste/utils/geometry.py:26-120 (`get_overlapping_views`),
    which intersects shapely polygons. Shapely-free redesign: sectors are
    rasterised onto a small grid around the query pose and the overlap is
    the fraction of the query sector covered — same coarse distance gate,
    same sector geometry, vectorised over all db poses.

    QUIRK reproduced (pinned by the reference-exec golden): the reference's
    `sector()` builds its polygon with *compass* angles (x = sin, y = cos,
    geometry.py:7) while the heading comes from `atan2(R10, R00)` (:40) — so
    a pose with heading θ gets a sector pointing along (sin θ, cos θ), the
    reflection of the camera axis across y = x. The on-disk overlap graphs
    carry this geometry, so we reproduce it: in-sector test compares the
    compass angle `atan2(dx, dy)` of the center→point ray against θ.

    Args:
      query_se2: [3, 3] query SE(2) pose (metres).
      db_se2: [N, 3, 3] database poses.
    Returns [N] overlap fractions in [0, 1].
    """
    q = np.asarray(query_se2, np.float64)
    db = np.asarray(db_se2, np.float64)
    N = db.shape[0]
    out = np.zeros((N,), np.float64)

    # coarse gate: centres at max_dist or further cannot overlap
    # (strict `<`, geometry.py:69)
    d = np.linalg.norm(db[:, :2, 2] - q[:2, 2], axis=1)
    cand = np.nonzero(d < max_dist)[0]
    if len(cand) == 0:
        return out

    # sample grid over the query sector's bounding square
    span = view_dist
    xs = np.linspace(q[0, 2] - span, q[0, 2] + span, grid)
    ys = np.linspace(q[1, 2] - span, q[1, 2] + span, grid)
    gx, gy = np.meshgrid(xs, ys)
    pts = np.stack([gx.ravel(), gy.ravel()], axis=1)  # [G, 2]

    def sector_mask(pose):
        rel = pts - pose[:2, 2]
        dist = np.linalg.norm(rel, axis=1)
        heading = np.arctan2(pose[1, 0], pose[0, 0])
        # compass angle of the ray (see QUIRK above)
        ang = np.arctan2(rel[:, 0], rel[:, 1]) - heading
        ang = (ang + np.pi) % (2 * np.pi) - np.pi
        half = np.deg2rad(fov_deg) / 2
        return (dist <= view_dist) & (np.abs(ang) <= half)

    qmask = sector_mask(q)
    qarea = max(qmask.sum(), 1)
    for i in cand:
        out[i] = (qmask & sector_mask(db[i])).sum() / qarea
    return out


def polygon_area(verts: np.ndarray) -> float:
    """Shoelace area of a simple polygon [N, 2] (orientation-free)."""
    v = np.asarray(verts, np.float64)
    if len(v) < 3:
        return 0.0
    w = np.roll(v, -1, axis=0)
    return abs(np.sum(v[:, 0] * w[:, 1] - w[:, 0] * v[:, 1])) / 2.0


def convex_clip(subject: np.ndarray, clip: np.ndarray) -> np.ndarray:
    """Sutherland-Hodgman clip of polygon ``subject`` [N, 2] by CONVEX
    polygon ``clip`` [M, 2] — the pure-NumPy replacement for the
    reference's shapely ``Polygon.intersection`` (creste/utils/
    geometry.py:3,78-81). Exact up to float arithmetic for convex inputs
    (the reference's FOV sectors are convex for fov < 180°). Each clip
    edge is processed with fully vectorised inner math."""
    out = np.asarray(subject, np.float64)
    clip = np.asarray(clip, np.float64)
    # CCW orientation so "inside" is the left half-plane of every edge
    w = np.roll(clip, -1, axis=0)
    if np.sum(clip[:, 0] * w[:, 1] - w[:, 0] * clip[:, 1]) < 0:
        clip = clip[::-1]
    for a, b in zip(clip, np.roll(clip, -1, axis=0)):
        if len(out) == 0:
            break
        if a[0] == b[0] and a[1] == b[1]:  # degenerate (duplicated apex)
            continue
        p = out
        q = np.roll(out, -1, axis=0)
        e = b - a
        cp = e[0] * (p[:, 1] - a[1]) - e[1] * (p[:, 0] - a[0])
        cq = e[0] * (q[:, 1] - a[1]) - e[1] * (q[:, 0] - a[0])
        keep_p = cp >= 0
        crossing = keep_p != (cq >= 0)
        denom = np.where(crossing, cp - cq, 1.0)
        t = np.where(crossing, cp / denom, 0.0)
        x = p + t[:, None] * (q - p)
        # ordered emit per edge: p (if inside) then crossing point
        cands = np.empty((2 * len(p), 2), np.float64)
        cands[0::2] = p
        cands[1::2] = x
        mask = np.empty(2 * len(p), bool)
        mask[0::2] = keep_p
        mask[1::2] = crossing
        out = cands[mask]
    return out


def sector_polygon(
    center_xy: np.ndarray,
    start_deg: float,
    end_deg: float,
    radius: float,
    steps: int = 200,
) -> np.ndarray:
    """The reference's FOV sector polygon, vertex-for-vertex
    (creste/utils/geometry.py:5-24 ``sector``): apex, ``steps+1`` arc
    samples, apex again — built with *compass* angles (x = sin, y = cos,
    geometry.py:7), the quirk the on-disk overlap graphs carry."""
    cx, cy = float(center_xy[0]), float(center_xy[1])
    if start_deg > end_deg:
        start_deg -= 360.0
    ang = np.deg2rad(np.linspace(start_deg, end_deg, steps + 1))
    arc_x = cx + np.sin(ang) * radius
    arc_y = cy + np.cos(ang) * radius
    verts = np.empty((steps + 3, 2), np.float64)
    verts[0] = (cx, cy)
    verts[1:-1, 0] = arc_x
    verts[1:-1, 1] = arc_y
    verts[-1] = (cx, cy)
    return verts


def fov_polygon_overlap(
    query_se2: np.ndarray,
    db_se2: np.ndarray,
    fov_deg: float = 70.0,
    view_dist: float = 12.8,
    max_dist: float = 19.2,
) -> np.ndarray:
    """Polygon-EXACT overlap fractions (convex clip + shoelace), matching
    the reference's shapely path (geometry.py:26-109) to float precision —
    same coarse distance gate, identical 202-gon sector geometry.

    Args: as ``fov_sector_overlap``. Returns [N] fractions in [0, 1]."""
    q = np.asarray(query_se2, np.float64)
    db = np.asarray(db_se2, np.float64)
    out = np.zeros((db.shape[0],), np.float64)
    d = np.linalg.norm(db[:, :2, 2] - q[:2, 2], axis=1)
    cand = np.nonzero(d < max_dist)[0]
    if len(cand) == 0:
        return out

    def pose_sector(pose):
        heading = np.degrees(np.arctan2(pose[1, 0], pose[0, 0]))
        return sector_polygon(
            pose[:2, 2], heading - fov_deg / 2, heading + fov_deg / 2,
            view_dist,
        )

    qpoly = pose_sector(q)
    qarea = polygon_area(qpoly)
    for i in cand:
        out[i] = polygon_area(convex_clip(qpoly, pose_sector(db[i]))) / qarea
    return out


def get_overlapping_views(
    query_idx: int,
    db_poses_se3: np.ndarray,
    tp_min: float = 0.1,
    tp_max: float = 0.8,
    fov_deg: float = 70.0,
    view_dist: float = 12.8,
    max_dist: float = 19.2,
    grid: int | None = None,
) -> np.ndarray:
    """Indices of db poses whose FOV overlap ratio with the query lies
    strictly inside (tp_min, tp_max) — geometry.py:87 contract. The query
    pose itself is excluded by the same filter (its self-overlap ratio is
    1.0 > tp_max; the reference's explicit exclusion is commented out at
    geometry.py:104).

    Default path is the polygon-exact clip (``fov_polygon_overlap``);
    pass ``grid`` to use the faster rasterised approximation instead."""
    se2 = np.zeros((db_poses_se3.shape[0], 3, 3))
    se2[:, :2, :2] = db_poses_se3[:, :2, :2]
    se2[:, :2, 2] = db_poses_se3[:, :2, 3]
    se2[:, 2, 2] = 1.0
    if grid is None:
        frac = fov_polygon_overlap(
            se2[query_idx], se2, fov_deg, view_dist, max_dist
        )
    else:
        frac = fov_sector_overlap(
            se2[query_idx], se2, fov_deg, view_dist, max_dist, grid=grid
        )
    ok = (frac > tp_min) & (frac < tp_max)
    return np.nonzero(ok)[0]


def quat_to_rotmat(q: np.ndarray) -> np.ndarray:
    """[..., 4] (qw, qx, qy, qz) -> [..., 3, 3] rotation matrices (the
    single quaternion implementation; calib delegates here)."""
    q = np.asarray(q, np.float64)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    m = np.empty(q.shape[:-1] + (3, 3), q.dtype)
    m[..., 0, 0] = 1 - 2 * (y * y + z * z)
    m[..., 0, 1] = 2 * (x * y - z * w)
    m[..., 0, 2] = 2 * (x * z + y * w)
    m[..., 1, 0] = 2 * (x * y + z * w)
    m[..., 1, 1] = 1 - 2 * (x * x + z * z)
    m[..., 1, 2] = 2 * (y * z - x * w)
    m[..., 2, 0] = 2 * (x * z - y * w)
    m[..., 2, 1] = 2 * (y * z + x * w)
    m[..., 2, 2] = 1 - 2 * (x * x + y * y)
    return m


def quat_to_matrix(qw: float, qx: float, qy: float, qz: float) -> np.ndarray:
    """Unit quaternion (w, x, y, z) -> 3x3 rotation matrix."""
    return quat_to_rotmat(np.array([qw, qx, qy, qz]))


def pose7_to_matrix(pose: np.ndarray) -> np.ndarray:
    """[ts?, x, y, z, qw, qx, qy, qz] (CODa dense pose row) -> 4x4 SE(3).

    Accepts either 7 values (x y z qw qx qy qz) or 8 (leading timestamp);
    reference: creste/datasets/coda_helpers.py:74 (convert_poses_to_tf).
    """
    pose = np.asarray(pose, dtype=np.float64)
    if pose.shape[-1] == 8:
        pose = pose[..., 1:]
    x, y, z, qw, qx, qy, qz = pose
    T = np.eye(4)
    T[:3, :3] = quat_to_matrix(qw, qx, qy, qz)
    T[:3, 3] = [x, y, z]
    return T


def relative_poses(poses: np.ndarray, ref_idx: int = 0) -> np.ndarray:
    """Express a chain of 4x4 world poses relative to poses[ref_idx]."""
    ref_inv = np.linalg.inv(poses[ref_idx])
    return np.einsum("ij,njk->nik", ref_inv, poses)


def se3_to_bev_se2(
    pose: np.ndarray, bev_hw: tuple[int, int], voxel: float
) -> np.ndarray:
    """Project a relative SE(3) pose into a 3x3 SE(2) on the BEV grid.

    Exactly the reference's T_lidar_to_bev construction
    (codapefree_dataloader.py:579-615, mirrored by
    data/coda_dataset.py::_traversability): the pose's xy translation in
    grid units is mapped by [[-1, 0, W//2], [0, -1, H//2]], so forward (+x)
    motion moves toward row 0 — the same orientation as the splat grid
    (splat_projection.py:81-88) and the north-facing FOV mask.
    """
    H, W = bev_hw
    se2 = np.eye(3, dtype=np.float64)
    se2[:2, :2] = pose[:2, :2]
    se2[:2, 2] = pose[:2, 3] / voxel
    # component 0 is the ROW (+x -> -row), so its offset is the row-centre
    # H//2; the reference literally writes bev_size[1]//2 there
    # (codapefree_dataloader.py:598-601), which is identical for its square
    # grids but swapped for non-square ones — we use the geometrically
    # correct centre.
    t_l2b = np.array(
        [[-1, 0, H // 2], [0, -1, W // 2], [0, 0, 1]], np.float64
    )
    return t_l2b @ se2
