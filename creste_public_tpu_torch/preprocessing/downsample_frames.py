"""Downsampled copies of the depth labels for the ground-truth
supervision (reference scripts/preprocessing/downsample_frames.py; the JAX
package's script of the same name): every ``factor``-th pixel of each PNG.

    python -m creste_public_tpu_torch.preprocessing.downsample_frames \
        --in_dir D --out_dir D_ds4 --factor 4 [--device cpu]

The work is PNG decode and encode on the host; ``--device`` is checked as
every preprocessing entry point checks it.
"""
from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from creste_public_tpu_torch.utils.concurrency import parallel_map
from creste_public_tpu_torch.utils.device import resolve_device


def downsample_one(job: tuple[str, str, int]) -> None:
    """(src, dst, factor); module-level so that a process pool can pickle
    it."""
    from PIL import Image

    src, dst, factor = job
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    img = np.asarray(Image.open(src))
    Image.fromarray(img[::factor, ::factor]).save(dst)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--in_dir", required=True)
    ap.add_argument("--out_dir", required=True)
    ap.add_argument("--factor", type=int, default=4)
    ap.add_argument("--workers", type=int, default=1,
                    help="process-pool size (reference Pool(24))")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    jobs = []
    for p in sorted(glob.glob(os.path.join(args.in_dir, "**", "*.png"),
                              recursive=True)):
        rel = os.path.relpath(p, args.in_dir)
        jobs.append((p, os.path.join(args.out_dir, rel), args.factor))
    parallel_map(downsample_one, jobs, workers=args.workers, mode="process")
    print(f"done ({len(jobs)} frames)")


if __name__ == "__main__":
    main()
