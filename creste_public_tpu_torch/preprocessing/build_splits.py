"""Train/val/test splits with curvature classification (reference
scripts/preprocessing/build_splits.py; the JAX package's script of the
same name) -> ``splits/{train,val,test,full}.txt`` and their distances.

    python -m creste_public_tpu_torch.preprocessing.build_splits \
        --root D --seqs 0 1 [--device cpu]
"""
from __future__ import annotations

import argparse
import os

from creste_public_tpu_torch.data.calib import load_poses
from creste_public_tpu_torch.preprocessing import splits as sp
from creste_public_tpu_torch.utils.concurrency import parallel_map
from creste_public_tpu_torch.utils.device import resolve_device


def classify_seq(job: tuple) -> tuple:
    """(root, seq, horizon, min_distance, curved_threshold) -> the
    sequence's classification; module-level for the process pool (the
    Hausdorff scan is GIL-bound NumPy)."""
    root, seq, horizon, min_distance, curved_threshold = job
    mats = load_poses(root, seq)
    return seq, sp.classify_curvature(
        mats, range(len(mats)), horizon, min_distance, curved_threshold)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--seqs", nargs="+", required=True)
    ap.add_argument("--horizon", type=int, default=100)
    ap.add_argument("--min_distance", type=float, default=3.0)
    ap.add_argument("--curved_threshold", type=float, default=0.5)
    ap.add_argument("--overlap", type=int, default=0,
                    help="if >0, thin samples whose horizon windows overlap "
                         "(reference build_splits.py:65)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--workers", type=int, default=1,
                    help="process-pool size over sequences")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    jobs = [(args.root, seq, args.horizon, args.min_distance,
             args.curved_threshold) for seq in args.seqs]
    results = parallel_map(classify_seq, jobs, workers=args.workers,
                           mode="process")
    samples, dists = [], {}
    for seq, (curved, straight, d) in results:
        samples += [(seq, f) for f in curved + straight]
        # keyed by (seq, frame): frame-only keys collide across sequences
        dists.update({(seq, f): v for f, v in d.items()})
    if args.overlap > 0:
        samples = sp.drop_overlapping_horizons(samples, args.overlap)
    parts = sp.train_val_test(samples)
    out = args.out or os.path.join(args.root, "splits")
    sp.write_split_files(out, parts, dists)
    print(f"wrote splits for {len(samples)} samples to {out}")


if __name__ == "__main__":
    main()
