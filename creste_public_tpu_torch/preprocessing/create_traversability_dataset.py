"""Valid expert-demonstration start frames per sequence (reference
scripts/preprocessing/create_traversability_dataset.py; the JAX package's
script of the same name) -> ``traversability/{seq}.txt``.

    python -m creste_public_tpu_torch.preprocessing.\
create_traversability_dataset --root D --seqs 0 [--device cpu]
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from creste_public_tpu_torch.preprocessing.splits import traversability_starts
from creste_public_tpu_torch.utils.concurrency import parallel_map
from creste_public_tpu_torch.utils.device import resolve_device


def starts_one(job: tuple) -> tuple[str, int]:
    """(root, seq, num_frames, dist_thresh) -> writes
    traversability/{seq}.txt; module-level for the process pool."""
    root, seq, num_frames, dist_thresh = job
    rows = np.loadtxt(
        os.path.join(root, "poses", "dense", f"{seq}.txt")).reshape(-1, 8)
    starts = traversability_starts(rows, num_frames, dist_thresh=dist_thresh)
    out_dir = os.path.join(root, "traversability")
    os.makedirs(out_dir, exist_ok=True)
    np.savetxt(os.path.join(out_dir, f"{seq}.txt"), starts, fmt="%d")
    return seq, len(starts)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--seqs", nargs="+", required=True)
    ap.add_argument("--num_frames", type=int, default=50)
    ap.add_argument("--dist_thresh", type=float, default=2.0)
    ap.add_argument("--workers", type=int, default=1,
                    help="process-pool size over sequences")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    jobs = [(args.root, seq, args.num_frames, args.dist_thresh)
            for seq in args.seqs]
    for seq, n in parallel_map(starts_one, jobs, workers=args.workers,
                               mode="process"):
        print(f"seq {seq}: {n} valid starts")


if __name__ == "__main__":
    main()
