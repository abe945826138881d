"""BEV SAM instance maps, static and dynamic (reference
scripts/preprocessing/build_sam_map.py; the JAX package's script of the
same name).

static: the per-pixel instances of ``2d_sam/`` lifted to the BEV grid
through the dense depth of each frame of a ``--horizon`` (each unprojected
with its pose-chained p2p) and merged anchor-first ->
``3d_sam/{seq}/{frame}.npy`` [grid, grid].

dynamic: the per-pixel labels of ``2d_sam_dynamic/`` moved onto the raw
LiDAR scan through the calibrated projection, the ground plane removed,
the points clustered by the DBSCAN ensemble on ``--device`` and matched to
instances -> ``3d_sam_dynamic/{seq}/{frame}.npy`` [grid, grid, 3].

    python -m creste_public_tpu_torch.preprocessing.build_sam_map \
        --root D --seqs 0 --mode dynamic [--device cpu]
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from creste_public_tpu_torch.data.calib import load_calibration, load_poses
from creste_public_tpu_torch.preprocessing import sam_map as sm
from creste_public_tpu_torch.preprocessing.depth import load_scan
from creste_public_tpu_torch.preprocessing.semantic_map import (
    labels_from_image,
)
from creste_public_tpu_torch.utils.concurrency import parallel_map
from creste_public_tpu_torch.utils.device import resolve_device


def load_depth_m(root, depth_dir, cam, seq, frame, ds):
    from PIL import Image

    path = os.path.join(root, depth_dir, cam, str(seq), f"{frame}.png")
    d = np.asarray(Image.open(path)).astype(np.float32) / 1000.0  # mm -> m
    return d[::ds, ::ds]


def load_sam_img(root, label_dir, cam, seq, frame, ds):
    path = os.path.join(root, label_dir, cam, str(seq), f"{frame}.npy")
    return np.load(path)[::ds, ::ds]


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--seqs", nargs="+", required=True)
    ap.add_argument("--cam", default="cam0")
    ap.add_argument("--mode", choices=["static", "dynamic"], default="static")
    ap.add_argument("--grid", type=int, default=256)
    ap.add_argument("--map_range", type=float, default=12.8)
    ap.add_argument("--horizon", type=int, default=5,
                    help="static: temporal merge horizon (anchor-first)")
    ap.add_argument("--ds", type=int, default=4,
                    help="image downsample for the unprojection")
    ap.add_argument("--depth_dir", default="depth_5_LA_all")
    ap.add_argument("--workers", type=int, default=os.cpu_count() or 1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    for seq in args.seqs:
        poses = load_poses(args.root, seq)
        calib = load_calibration(args.root, seq, args.cam)
        p2p = calib.pixel_to_point(ds=args.ds)
        img_dir = "2d_sam" if args.mode == "static" else "2d_sam_dynamic"
        out_name = "3d_sam" if args.mode == "static" else "3d_sam_dynamic"
        out_dir = os.path.join(args.root, out_name, str(seq))
        os.makedirs(out_dir, exist_ok=True)
        n_frames = len(poses)

        def one(frame):
            out = os.path.join(out_dir, f"{frame}.npy")
            if os.path.exists(out):
                return
            try:
                if args.mode == "static":
                    ids = np.clip(np.arange(frame, frame + args.horizon),
                                  0, n_frames - 1)
                    ids = list(dict.fromkeys(int(i) for i in ids))
                    frames = []
                    for f in ids:
                        sam = load_sam_img(args.root, img_dir, args.cam, seq,
                                           f, args.ds)
                        depth = load_depth_m(args.root, args.depth_dir,
                                             args.cam, seq, f, args.ds)
                        chained = (np.linalg.inv(poses[frame])
                                   @ poses[f] @ p2p)
                        frames.append((sam, depth, chained))
                    label = sm.static_bev_map_horizon(
                        frames, args.grid, args.map_range,
                        depth_range=(0.0, args.map_range))
                else:
                    img = np.load(os.path.join(
                        args.root, img_dir, args.cam, str(seq),
                        f"{frame}.npy"))
                    if img.ndim == 2:  # instance-only map: class = occupancy
                        img = np.stack([img, (img > 0).astype(img.dtype)], -1)
                    pts = load_scan(args.root, seq, frame)
                    pl, _ = labels_from_image(pts, img, calib.lidar2camrect)
                    label = sm.dynamic_sam_map(
                        pts, pl[:, 0].astype(np.int64),
                        pl[:, 1].astype(np.int64),
                        args.grid, args.map_range, device=dev)
                np.save(out, label.astype(np.uint16))
            except FileNotFoundError as e:
                print(f"skip {seq}/{frame}: {e}")

        parallel_map(one, range(n_frames), args.workers)
        print(f"seq {seq}: SAM maps at {out_dir}")


if __name__ == "__main__":
    main()
