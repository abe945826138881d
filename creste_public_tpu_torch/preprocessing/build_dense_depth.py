"""Dense depth labels for every frame of the given sequences (reference
scripts/preprocessing/build_dense_depth.py; the JAX package's
scripts/preprocessing/build_dense_depth.py).

    python -m creste_public_tpu_torch.preprocessing.build_dense_depth \
        --root data/creste --seqs 0 1 --scans 5 --proc LAIDW [--device cpu]
"""
from __future__ import annotations

import argparse
import os

from creste_public_tpu_torch.data.calib import load_poses
from creste_public_tpu_torch.preprocessing.depth import build_sequence_depth
from creste_public_tpu_torch.utils.device import resolve_device


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--seqs", nargs="+", required=True)
    ap.add_argument("--scans", type=int, default=5)
    ap.add_argument("--proc", choices=["LA", "LAIDW"], default="LA")
    ap.add_argument("--cam", default="cam0")
    ap.add_argument("--out_root", default=None)
    ap.add_argument("--workers", type=int, default=os.cpu_count() or 1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    for seq in args.seqs:
        frames = range(len(load_poses(args.root, seq)))
        written = build_sequence_depth(
            args.root, seq, frames, scans=args.scans, proc=args.proc,
            cam=args.cam, out_root=args.out_root, workers=args.workers,
            device=dev)
        print(f"seq {seq}: wrote {len(written)} depth maps")


if __name__ == "__main__":
    main()
