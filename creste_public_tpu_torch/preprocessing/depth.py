"""Dense depth labels: LiDAR accumulation -> z-buffer -> IDW.

Counterpart of ``creste_public_tpu/preprocessing/depth.py`` (reference
scripts/preprocessing/build_dense_depth.py):
  * per frame, ``scans`` neighbouring clouds go through the pose chain into
    the reference LiDAR frame (:224-366),
  * and through ``lidar2camrect`` with per-pixel max-depth priority
    (projection.py:64-146);
  * 'LA' stops there; 'LAIDW' refills the bottom third from a 50-scan
    accumulation and runs IDW infill (:415-447);
  * uint16 millimetre PNGs go under
    ``depth_{scans}_{proc}_{type}/{cam}/{seq}/{frame}.png`` (:451-467).

The projection and the infill run on ``device``; the host decodes the
``.bin`` files and writes the PNGs.
"""
from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import torch

from creste_public_tpu_torch.data import coda_constants as cc
from creste_public_tpu_torch.data.calib import (
    Calibration,
    load_calibration,
    load_poses,
)
from creste_public_tpu_torch.ops.depth_projection import (
    accumulate_and_project,
)
from creste_public_tpu_torch.ops.infill import idw_densify
from creste_public_tpu_torch.utils.concurrency import parallel_map
from creste_public_tpu_torch.utils.device import resolve_device


def load_scan(root: str, seq: str, frame: int) -> np.ndarray:
    """Ouster .bin -> [N, 3] xyz."""
    path = cc.frame_path(root, cc.POINTCLOUD_DIR, cc.DEFAULT_LIDAR, seq,
                         frame, "bin")
    raw = np.fromfile(path, np.float32)
    feats = cc.OUSTER_FEATURES if raw.size % cc.OUSTER_FEATURES == 0 else 5
    return raw.reshape(-1, feats)[:, :3]


def depth_label_dirname(scans: int, proc: str, kind: str = "all") -> str:
    return f"depth_{scans}_{proc}_{kind}"


def _project(scans_xyz: Sequence[np.ndarray], poses: np.ndarray,
             ref_pose: np.ndarray, l2r: torch.Tensor,
             img_hw: tuple[int, int], dev: torch.device) -> torch.Tensor:
    n = min(len(s) for s in scans_xyz)
    stack = torch.from_numpy(np.stack([s[:n] for s in scans_xyz])).to(dev)
    return accumulate_and_project(stack, poses, ref_pose, l2r, img_hw)


def compute_depth_frame(
    scans_xyz: Sequence[np.ndarray],
    scan_poses: np.ndarray,
    ref_pose: np.ndarray,
    calib: Calibration,
    img_hw: tuple[int, int],
    proc: str = "LA",
    idw_window: int = 4,
    bottom_scans_xyz: Sequence[np.ndarray] | None = None,
    bottom_poses: np.ndarray | None = None,
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """One frame's dense depth map in metres [H, W] (0 = empty)."""
    if proc not in ("LA", "LAIDW"):
        raise ValueError(f"Unknown proc mode: {proc}")
    dev = resolve_device(device)
    l2r = np.asarray(calib.lidar2camrect, np.float32)
    if l2r.shape == (3, 4):
        l2r = np.vstack([l2r, [0, 0, 0, 1]]).astype(np.float32)
    l2r = torch.from_numpy(l2r).to(dev)
    depth = _project(scans_xyz, scan_poses, ref_pose, l2r, img_hw, dev)
    if proc == "LA":
        return depth.cpu().numpy()
    # the bottom third refilled from the long accumulation window
    if bottom_scans_xyz is not None and len(bottom_scans_xyz):
        bottom = _project(bottom_scans_xyz, bottom_poses, ref_pose, l2r,
                          img_hw, dev)
        cut = 2 * img_hw[0] // 3
        region = depth[cut:]
        depth = torch.cat(
            [depth[:cut], torch.where(region > 0, region, bottom[cut:])])
    return idw_densify(depth=depth, window=idw_window).cpu().numpy()


def save_depth_png(path: str, depth_m: np.ndarray) -> None:
    from PIL import Image

    os.makedirs(os.path.dirname(path), exist_ok=True)
    mm = np.clip(depth_m * 1000.0, 0, 65535).astype(np.uint16)
    Image.fromarray(mm).save(path)


def build_sequence_depth(
    root: str,
    seq: str,
    frames: Sequence[int],
    scans: int = 5,
    proc: str = "LA",
    cam: str = cc.DEFAULT_CAM,
    out_root: str | None = None,
    skip_existing: bool = True,
    workers: int = 1,
    device: str | torch.device = "cuda",
) -> list[str]:
    """Depth labels for a sequence; returns the paths written.

    ``workers`` > 1 runs frames on a thread pool: the scan loads are I/O,
    and the projection's kernels release the GIL.
    """
    dev = resolve_device(device)
    out_root = out_root or root
    calib = load_calibration(root, seq, cam)
    poses = load_poses(root, seq)
    out_dir = os.path.join(out_root, depth_label_dirname(scans, proc), cam,
                           str(seq))
    half = scans // 2

    def one(frame: int) -> str | None:
        out_path = os.path.join(out_dir, f"{frame}.png")
        if skip_existing and os.path.exists(out_path):
            return None
        ids = np.clip(np.arange(frame - half, frame - half + scans), 0,
                      len(poses) - 1)
        scans_xyz = [load_scan(root, seq, int(i)) for i in ids]
        bottom_xyz, bottom_poses = None, None
        if proc == "LAIDW":
            bids = np.clip(np.arange(frame - 25, frame + 25), 0,
                           len(poses) - 1)
            bottom_xyz = [load_scan(root, seq, int(i)) for i in bids]
            bottom_poses = poses[bids]
        depth = compute_depth_frame(
            scans_xyz, poses[ids], poses[frame], calib, calib.img_hw,
            proc=proc, bottom_scans_xyz=bottom_xyz,
            bottom_poses=bottom_poses, device=dev)
        save_depth_png(out_path, depth)
        return out_path

    return [r for r in parallel_map(one, frames, workers) if r is not None]
