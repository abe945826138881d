"""BEV geometric and semantic labels from accumulated LiDAR (reference
scripts/preprocessing/build_feature_map.py; the JAX package's script of
the same name). Tasks:

  elevation : the reference's shipped Map2D labels (``.bin``, default) or
              the gap-scan lower/upper elevation (``--elevation_mode
              gapscan``, ``.npy``), on ``--device``
  3d_ssc    : per-voxel semantic class-count bins, int64 [grid, grid, 25]
  3d_soc    : per-voxel object class-count bins, uint16 [grid, grid, 60]
  3d_fsc    : per-voxel GMP/GAP feature descriptors, f32 [grid, grid, F]

Per-point labels come from ``{label_dir}/{seq}/{frame}.bin`` (uint32 ids,
``--label_source points``) or are lifted from per-pixel ``{frame}.npy``
images through the calibrated projection (``--label_source image``).

    python -m creste_public_tpu_torch.preprocessing.build_feature_map \
        --root D --seqs 0 --tasks elevation 3d_ssc [--device cpu]
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from creste_public_tpu_torch.data.calib import load_poses
from creste_public_tpu_torch.ops.depth_projection import accumulate_scans
from creste_public_tpu_torch.ops.elevation import elevation_maps_from_points
from creste_public_tpu_torch.preprocessing.depth import load_scan
from creste_public_tpu_torch.preprocessing.semantic_map import (
    build_count_bins,
    build_descriptor_bins,
    build_elevation_bins,
)
from creste_public_tpu_torch.utils.concurrency import parallel_map
from creste_public_tpu_torch.utils.device import resolve_device


def build_elevation(args, seq, dev):
    """The shipped path (default): the window-accumulated labelled map ->
    Map2D robust-min and kernel maps, ``.bin`` f32 (reference
    build_feature_map.py:770-780). ``gapscan`` writes the lower/upper
    gap-scan maps as ``.npy``."""
    if args.elevation_mode == "reference":
        n = build_elevation_bins(
            args.root, seq, args.sem_label_dir,
            out_dir=os.path.join(args.root, "elevation"),
            var_dir=os.path.join(args.root, "variance"),
            grid=args.grid, map_range=args.map_range, window=args.window,
            label_source=args.label_source, workers=args.workers,
            device=dev)
        print(f"seq {seq}: {n} elevation labels at "
              f"{os.path.join(args.root, 'elevation')}")
        return

    poses = load_poses(args.root, seq)
    out_dir = os.path.join(args.root, "elevation", str(seq))
    os.makedirs(out_dir, exist_ok=True)
    half = args.scans // 2

    def one(frame):
        out = os.path.join(out_dir, f"{frame}.npy")
        if os.path.exists(out):
            return
        ids = np.clip(np.arange(frame - half, frame - half + args.scans),
                      0, len(poses) - 1)
        scans = [load_scan(args.root, seq, int(i)) for i in ids]
        n = min(len(s) for s in scans)
        merged = accumulate_scans(
            torch.from_numpy(np.stack([s[:n] for s in scans])).to(dev),
            poses[ids], poses[frame])
        maps = elevation_maps_from_points(merged, (args.grid, args.grid),
                                          args.map_range)
        label = torch.stack([maps["lower"], maps["upper"]], -1)
        np.save(out, label.cpu().numpy().astype(np.float32))

    parallel_map(one, range(len(poses)), args.workers)
    print(f"seq {seq}: elevation labels at {out_dir}")


def build_ssc(args, seq, task):
    if task == "3d_ssc":
        label_dir, num_classes, dtype = args.sem_label_dir, 25, "int64"
    else:
        label_dir, num_classes, dtype = args.obj_label_dir, 60, "uint16"
    n = build_count_bins(
        args.root, seq, label_dir, out_dir=os.path.join(args.root, task),
        grid=args.grid, map_range=args.map_range, num_classes=num_classes,
        out_dtype=dtype, window=args.window, label_source=args.label_source,
        workers=args.workers)
    print(f"seq {seq}: {n} {task} scenes at {os.path.join(args.root, task)}")


def build_fsc(args, seq):
    n = build_descriptor_bins(
        args.root, seq, args.feat_dir,
        out_dir=os.path.join(args.root, "3d_fsc"), grid=args.grid,
        map_range=args.map_range, window=args.window, ds=args.ds,
        aggregator=args.aggregator, workers=args.workers)
    print(f"seq {seq}: {n} 3d_fsc scenes")


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--seqs", nargs="+", required=True)
    ap.add_argument("--tasks", nargs="+", default=["elevation"],
                    choices=["elevation", "3d_ssc", "3d_soc", "3d_fsc"])
    ap.add_argument("--grid", type=int, default=256)
    ap.add_argument("--map_range", type=float, default=12.8)
    ap.add_argument("--scans", type=int, default=10,
                    help="elevation accumulation horizon (gapscan mode)")
    ap.add_argument("--elevation_mode", default="reference",
                    choices=["reference", "gapscan"],
                    help="reference: shipped Map2D pipeline -> .bin; "
                         "gapscan: lower/upper gap-scan kernel -> .npy")
    ap.add_argument("--window", type=int, default=50,
                    help="semantic-map lookback (reference WINDOW_SIZE)")
    ap.add_argument("--sem_label_dir", default="3d_semantic")
    ap.add_argument("--obj_label_dir", default="3d_objects")
    ap.add_argument("--label_source", default="points",
                    choices=["points", "image"])
    ap.add_argument("--feat_dir", default="distillation/cam0",
                    help="3d_fsc: per-frame feature maps (create_pe_dataset)")
    ap.add_argument("--ds", type=int, default=4,
                    help="3d_fsc: feature-map downsample vs camera res")
    ap.add_argument("--aggregator", default="GMP", choices=["GMP", "GAP"])
    ap.add_argument("--workers", type=int, default=os.cpu_count() or 1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    for seq in args.seqs:
        for task in args.tasks:
            if task == "elevation":
                build_elevation(args, seq, dev)
            elif task == "3d_fsc":
                build_fsc(args, seq)
            else:
                build_ssc(args, seq, task)


if __name__ == "__main__":
    main()
