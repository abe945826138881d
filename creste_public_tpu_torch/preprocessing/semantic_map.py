"""Global semantic point map -> per-pose SSC/SOC count-bin labels.

Counterpart of ``creste_public_tpu/preprocessing/semantic_map.py``: host
NumPy, except the shipped elevation labels, whose Map2D pipeline
(``ops.elevation.reference_elevation_maps``) runs in torch on ``device``.
Parity target: `SemanticMap` + the ssc task of the reference's
scripts/preprocessing/build_feature_map.py:55-291 (add_points /
get_pointcloud_from_pose) and :296-345 (get_scene_from_pose count binning),
:660-705 (save_scene_to_file with bev_scene flip). Per-pixel labels are
lifted onto LiDAR points with the in-FOV projection of
creste/utils/projection.py:64-110 (`pixels_to_depth` pc_pts/pc_mask
semantics — every in-frustum point takes the label under its pixel; no
occlusion culling is applied for label transfer, matching the reference).

Note: the public reference's `process_chunk` (build_feature_map.py:885-897)
contains dead debug state that replaces the computed semantic labels with
all-ones occupancy before accumulation; the released `3d_ssc` labels are
count bins over real class ids, which is what `_load_ssc`
(codapefree_dataloader.py:656-672) consumes and what this module produces.

On-disk contract (matching data/coda_dataset.py::_load_count_bin):
  3d_ssc/{seq}/{frame}.bin : int64  [grid, grid, 25]  raw SEM class counts
  3d_soc/{seq}/{frame}.bin : uint16 [grid, grid, 60]  raw OBJ class counts

The count binning is an integer scatter-add (np.bincount) on the host:
exact, and small beside the file I/O.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np
import torch

from creste_public_tpu_torch.data.calib import load_calibration, load_poses
from creste_public_tpu_torch.ops.elevation import reference_elevation_maps
from creste_public_tpu_torch.utils.concurrency import parallel_map
from creste_public_tpu_torch.utils.device import resolve_device


def project_points_to_pixels(
    points: np.ndarray, lidar2camrect: np.ndarray, img_h: int, img_w: int
) -> tuple[np.ndarray, np.ndarray]:
    """LiDAR points -> integer pixel coords + in-frustum mask.

    Reference: pixels_to_depth (projection.py:64-110): rectified-camera
    projection, int32 truncation (not rounding), z>0 and image-bounds mask.

    Returns:
      uv: [N, 2] int32 (col, row) pixel coords (valid where mask).
      mask: [N] bool in-frustum mask.
    """
    pts = points[:, :3].astype(np.float64)
    homo = np.concatenate([pts, np.ones_like(pts[:, :1])], axis=1)
    cam = (lidar2camrect @ homo.T).T[:, :3]
    z = cam[:, 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        uv = cam[:, :2] / z.reshape(-1, 1)
    uv = np.clip(np.nan_to_num(uv), np.iinfo(np.int32).min,
                 np.iinfo(np.int32).max).astype(np.int32)
    mask = (
        (z > 0)
        & (uv[:, 0] >= 0) & (uv[:, 0] < img_w)
        & (uv[:, 1] >= 0) & (uv[:, 1] < img_h)
    )
    return uv, mask


def labels_from_image(
    points: np.ndarray, label_img: np.ndarray, lidar2camrect: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Per-point labels gathered from a per-pixel label image.

    Reference: SemanticMap.convert_labels_to_bev (build_feature_map.py:185-222).

    Args:
      points: [N, 3] LiDAR-frame points.
      label_img: [H, W] or [H, W, F] per-pixel labels.
      lidar2camrect: [3|4, 4] projection (pixel = K R T point).

    Returns:
      labels: [N, F] per-point labels (0 where not in frustum).
      mask: [N] in-frustum mask.
    """
    if label_img.ndim == 2:
        label_img = label_img[..., None]
    H, W, F = label_img.shape
    uv, mask = project_points_to_pixels(points, lidar2camrect, H, W)
    labels = np.zeros((points.shape[0], F), label_img.dtype)
    labels[mask] = label_img[uv[mask, 1], uv[mask, 0]]
    return labels, mask


@dataclass
class SemanticPointMap:
    """Accumulates labelled points in the global frame; crops ego scenes.

    Mirrors SemanticMap (build_feature_map.py:55-291) with the same grid
    conventions: grid_range = [xmin, ymin, xmax, ymax] metres in the ego
    frame, voxel_size = (vx, vy).
    """

    grid_dims: tuple[int, int]  # (H, W) cells
    voxel_size: tuple[float, float]
    grid_range: tuple[float, float, float, float]
    max_z: float = 3.0
    _points: list = field(default_factory=list)
    _labels: list = field(default_factory=list)

    def add_frame(
        self,
        points: np.ndarray,
        labels: np.ndarray,
        pose: np.ndarray,
        filter_labels: bool = True,
    ) -> None:
        """Add one frame of labelled points (add_points, :91-132).

        Args:
          points: [N, 3] LiDAR-frame points.
          labels: [N] or [N, F] integer labels.
          pose: [4, 4] lidar->global.
        """
        if labels.ndim == 1:
            labels = labels[:, None]
        mask = points[:, 2] < self.max_z
        if filter_labels:
            mask &= (labels > 0).all(axis=1)
        pts = points[mask, :3]
        homo = np.concatenate([pts, np.ones_like(pts[:, :1])], axis=1)
        world = (pose @ homo.T).T[:, :3]
        self._points.append(world.astype(np.float32))
        self._labels.append(labels[mask])

    def reset(self) -> None:
        self._points.clear()
        self._labels.clear()

    def crop_at_pose(self, pose: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Egocentric crop (get_pointcloud_from_pose, :230-269): transform
        all map points by pose^-1, keep those inside grid_range (xy)."""
        if not self._points:
            return (np.zeros((0, 3), np.float32),
                    np.zeros((0, 1), np.int64))
        pts = np.concatenate(self._points)
        labels = np.concatenate(self._labels)
        inv = np.linalg.inv(pose)
        homo = np.concatenate([pts, np.ones_like(pts[:, :1])], axis=1)
        local = (inv @ homo.T).T[:, :3]
        lo = np.asarray(self.grid_range[:2], np.float32)
        hi = np.asarray(self.grid_range[2:], np.float32)
        m = ((local[:, :2] >= lo) & (local[:, :2] < hi)).all(axis=1)
        return local[m], labels[m]

    def scene_at_pose(self, pose: np.ndarray, num_classes: int) -> np.ndarray:
        """Per-voxel class-count bins at a pose (get_scene_from_pose,
        :296-345 + the bev_scene flip of save_scene_to_file:675).

        Returns [H, W, num_classes] int64 counts, BEV-flipped.
        """
        local, labels = self.crop_at_pose(pose)
        Hg, Wg = self.grid_dims
        lo = np.asarray(self.grid_range[:2], np.float32)
        vox = np.floor((local[:, :2] - lo) / np.asarray(self.voxel_size))
        vox = np.clip(vox, 0, np.asarray([Hg - 1, Wg - 1])).astype(np.int64)
        cls = np.clip(labels[:, 0].astype(np.int64), 0, num_classes - 1)
        flat = (vox[:, 0] * Wg + vox[:, 1]) * num_classes + cls
        counts = np.bincount(flat, minlength=Hg * Wg * num_classes)
        scene = counts.reshape(Hg, Wg, num_classes)
        return scene[::-1, ::-1].copy()  # torch.flip(scene, [0, 1])


def aggregate_descriptors(
    cells: np.ndarray, descriptors: np.ndarray, dims: tuple[int, int],
    aggregator: str = "GMP",
) -> np.ndarray:
    """Per-voxel descriptor aggregation (creste/utils/aggregator_utils.py:7):
    GMP = per-cell max, GAP = per-cell mean; empty cells are zero.

    cells: [N, 2] (row, col) voxel ids; descriptors: [N, F].
    Returns [H, W, F] float32.
    """
    H, W = dims
    N, F = descriptors.shape
    flat = cells[:, 0] * W + cells[:, 1]
    order = np.argsort(flat, kind="stable")
    flat_s = flat[order]
    desc_s = descriptors[order].astype(np.float32)
    out = np.zeros((H * W, F), np.float32)
    if N == 0:
        return out.reshape(H, W, F)
    starts = np.concatenate([[0], np.nonzero(np.diff(flat_s))[0] + 1])
    ends = np.concatenate([starts[1:], [N]])
    uniq = flat_s[starts]
    if aggregator == "GMP":
        red = np.maximum.reduceat(desc_s, starts, axis=0)
    elif aggregator == "GAP":
        red = np.add.reduceat(desc_s, starts, axis=0) / (
            (ends - starts)[:, None]
        )
    else:
        raise ValueError(f"Invalid aggregator {aggregator}")
    out[uniq] = red
    return out.reshape(H, W, F)


def descriptor_scene_at_pose(
    smap: SemanticPointMap, pose: np.ndarray, aggregator: str = "GMP"
) -> np.ndarray:
    """FSC label: per-voxel GMP/GAP descriptor map at a pose (the
    num_classes==0 branch of get_scene_from_pose, build_feature_map.py:
    336-345, + the bev_scene flip). The map's float labels are treated as
    descriptors. Returns [H, W, F] float32, BEV-flipped.
    """
    local, labels = smap.crop_at_pose(pose)
    Hg, Wg = smap.grid_dims
    lo = np.asarray(smap.grid_range[:2], np.float32)
    vox = np.floor((local[:, :2] - lo) / np.asarray(smap.voxel_size))
    vox = np.clip(vox, 0, np.asarray([Hg - 1, Wg - 1])).astype(np.int64)
    scene = aggregate_descriptors(vox, labels.astype(np.float32),
                                  (Hg, Wg), aggregator)
    return scene[::-1, ::-1].copy()


def build_count_bins(
    root: str,
    seq: str,
    label_dir: str,
    out_dir: str,
    grid: int = 256,
    map_range: float = 12.8,
    num_classes: int = 25,
    out_dtype: str = "int64",
    window: int = 50,
    chunk: int = 200,
    label_source: str = "points",
    frames: list[int] | None = None,
    workers: int = 1,
) -> int:
    """The SSC/SOC count bins of one sequence.

    Mirrors process_chunk (build_feature_map.py:786-905): frames are
    processed in chunks; each chunk accumulates a `window`-frame lookback of
    labelled points into the map, then saves an egocentric count-bin scene
    for every frame in the chunk.

    label_source 'points': {label_dir}/{seq}/{frame}.bin per-point labels.
    label_source 'image':  {label_dir}/{seq}/{frame}.npy per-pixel labels,
      lifted through the calibrated projection (labels_from_image).

    Returns the number of scenes written.
    """
    from creste_public_tpu_torch.preprocessing.depth import load_scan

    poses = load_poses(root, seq)
    n_frames = len(poses)
    frames = list(range(n_frames)) if frames is None else list(frames)
    voxel = 2.0 * map_range / grid
    os.makedirs(os.path.join(out_dir, str(seq)), exist_ok=True)

    lidar2camrect = None
    if label_source == "image":
        calib = load_calibration(root, seq)
        lidar2camrect = calib.lidar2camrect

    def load_labels(frame: int, points: np.ndarray) -> np.ndarray:
        base = os.path.join(root, label_dir, str(seq), str(frame))
        if label_source == "points":
            return np.fromfile(base + ".bin", np.uint32).astype(np.int64)
        img = np.load(base + ".npy")
        labels, _ = labels_from_image(points, img, lidar2camrect)
        return labels[:, 0].astype(np.int64)

    written = 0
    for c0 in range(frames[0], frames[-1] + 1, chunk):
        c1 = min(c0 + chunk, frames[-1] + 1)
        todo = [f for f in frames if c0 <= f < c1 and not os.path.exists(
            os.path.join(out_dir, str(seq), f"{f}.bin"))]
        if not todo:
            continue
        smap = SemanticPointMap(
            (grid, grid), (voxel, voxel),
            (-map_range, -map_range, map_range, map_range),
        )
        for f in range(max(0, c0 - window), c1):
            pts = load_scan(root, seq, f)[:, :3]
            smap.add_frame(pts, load_labels(f, pts), poses[f])

        def save_one(f: int) -> None:
            scene = smap.scene_at_pose(poses[f], num_classes)
            scene.astype(out_dtype).tofile(
                os.path.join(out_dir, str(seq), f"{f}.bin"))

        parallel_map(save_one, todo, workers)
        written += len(todo)
    return written


def build_elevation_bins(
    root: str,
    seq: str,
    label_dir: str,
    out_dir: str,
    var_dir: str,
    grid: int = 256,
    map_range: float = 12.8,
    window: int = 50,
    chunk: int = 200,
    label_source: str = "points",
    frames: list[int] | None = None,
    workers: int = 1,
    device: str | torch.device = "cuda",
) -> int:
    """Reference-SHIPPED elevation labels: process_single_frame's
    ELEVATION branch (build_feature_map.py:770-780) — the window-accumulated
    labelled map cropped at each pose (get_pointcloud_from_pose) and run
    through the Map2D robust-min + 3x3-kernel pipeline
    (ops/elevation.reference_elevation_maps, every shipped quirk carried). Writes float32 [grid, grid, 2] elevation and
    [grid, grid] variance `.bin` files in the reference's on-disk format
    (_load_elevation, codapefree_dataloader.py:617-625).

    Returns the number of scenes written.
    """
    from creste_public_tpu_torch.preprocessing.depth import load_scan

    dev = resolve_device(device)
    poses = load_poses(root, seq)
    frames = list(range(len(poses))) if frames is None else list(frames)
    voxel = 2.0 * map_range / grid
    os.makedirs(os.path.join(out_dir, str(seq)), exist_ok=True)
    os.makedirs(os.path.join(var_dir, str(seq)), exist_ok=True)

    lidar2camrect = None
    if label_source == "image":
        calib = load_calibration(root, seq)
        lidar2camrect = calib.lidar2camrect

    def load_labels(frame: int, points: np.ndarray) -> np.ndarray:
        base = os.path.join(root, label_dir, str(seq), str(frame))
        if label_source == "points":
            return np.fromfile(base + ".bin", np.uint32).astype(np.int64)
        img = np.load(base + ".npy")
        labels, _ = labels_from_image(points, img, lidar2camrect)
        return labels[:, 0].astype(np.int64)

    written = 0
    for c0 in range(frames[0], frames[-1] + 1, chunk):
        c1 = min(c0 + chunk, frames[-1] + 1)
        # idempotent-by-skip requires BOTH outputs (elevation + variance)
        # to exist: an interrupted run must backfill a missing var bin
        todo = [f for f in frames if c0 <= f < c1 and not (
            os.path.exists(os.path.join(out_dir, str(seq), f"{f}.bin"))
            and os.path.exists(
                os.path.join(var_dir, str(seq), f"{f}.bin")))]
        if not todo:
            continue
        smap = SemanticPointMap(
            (grid, grid), (voxel, voxel),
            (-map_range, -map_range, map_range, map_range),
        )
        for f in range(max(0, c0 - window), c1):
            pts = load_scan(root, seq, f)[:, :3]
            smap.add_frame(pts, load_labels(f, pts), poses[f])

        def save_one(f: int) -> None:
            local, labels = smap.crop_at_pose(poses[f])
            # at least one point (an empty crop gives one class-0 point,
            # which is ignored), as the JAX package pads
            n = max(1, len(local))
            pts = np.zeros((n, 3), np.float32)
            pts[: len(local)] = local
            lab = np.zeros((n,), np.int64)
            lab[: len(local)] = labels[:, 0]
            elev, var = reference_elevation_maps(
                torch.from_numpy(pts).to(dev), torch.from_numpy(lab).to(dev),
                (grid, grid), 2.0 * map_range, 2.0 * map_range)
            elev, var = elev.cpu().numpy(), var.cpu().numpy()
            np.asarray(elev, np.float32).tofile(
                os.path.join(out_dir, str(seq), f"{f}.bin"))
            np.asarray(var, np.float32).tofile(
                os.path.join(var_dir, str(seq), f"{f}.bin"))

        parallel_map(save_one, todo, workers)
        written += len(todo)
    return written


def build_descriptor_bins(
    root: str,
    seq: str,
    feat_dir: str,
    out_dir: str,
    grid: int = 256,
    map_range: float = 12.8,
    window: int = 50,
    chunk: int = 200,
    ds: int = 4,
    aggregator: str = "GMP",
    frames: list[int] | None = None,
    workers: int = 1,
) -> int:
    """FSC labels: per-pixel feature maps (create_pe_dataset output at
    feature resolution H/ds x W/ds) lifted onto LiDAR points, accumulated,
    and GMP-aggregated per voxel per pose (the reference's
    `--tasks 3d_fsc --feat_type fimg_label` path). Writes float32
    [grid, grid, F] `.bin` files `_load_fsc` can read
    (codapefree_dataloader.py:650-654).
    """
    from creste_public_tpu_torch.preprocessing.depth import load_scan

    poses = load_poses(root, seq)
    frames = list(range(len(poses))) if frames is None else list(frames)
    voxel = 2.0 * map_range / grid
    os.makedirs(os.path.join(out_dir, str(seq)), exist_ok=True)
    calib = load_calibration(root, seq).scaled(1.0 / ds)
    l2r = calib.lidar2camrect

    written = 0
    for c0 in range(frames[0], frames[-1] + 1, chunk):
        c1 = min(c0 + chunk, frames[-1] + 1)
        todo = [f for f in frames if c0 <= f < c1 and not os.path.exists(
            os.path.join(out_dir, str(seq), f"{f}.bin"))]
        if not todo:
            continue
        smap = SemanticPointMap(
            (grid, grid), (voxel, voxel),
            (-map_range, -map_range, map_range, map_range),
        )
        for f in range(max(0, c0 - window), c1):
            pts = load_scan(root, seq, f)[:, :3]
            fmap = np.load(os.path.join(root, feat_dir, str(seq),
                                        f"{f}.npy"))
            if fmap.ndim == 3 and fmap.shape[0] < fmap.shape[-1]:
                fmap = np.moveaxis(fmap, 0, -1)
            feats, mask = labels_from_image(pts, fmap, l2r)
            smap.add_frame(pts[mask], feats[mask], poses[f],
                           filter_labels=False)

        def save_one(f: int) -> None:
            scene = descriptor_scene_at_pose(smap, poses[f], aggregator)
            scene.astype(np.float32).tofile(
                os.path.join(out_dir, str(seq), f"{f}.bin"))

        parallel_map(save_one, todo, workers)
        written += len(todo)
    return written
