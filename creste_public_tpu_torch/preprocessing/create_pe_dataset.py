"""Distillation feature labels (reference
scripts/preprocessing/create_pe_dataset.py; the JAX package's script of
the same name): an extractor's patch features, a PCA fitted on a sample
of them, and each frame's projection resized to the backbone's feature
resolution -> ``distillation/{cam}/{seq}/{frame}.npy`` [H, W, k] f32.

    python -m creste_public_tpu_torch.preprocessing.create_pe_dataset \
        --root D --seqs 0 --pca_dim 128 --out_hw 128 153 [--device cpu]

Without DINOv2 weights on disk, ``--extractor auto`` runs the seeded
random projection.
"""
from __future__ import annotations

import argparse
import glob
import os
import zlib

import numpy as np
import torch

from creste_public_tpu_torch.preprocessing import features as F
from creste_public_tpu_torch.utils.concurrency import parallel_map
from creste_public_tpu_torch.utils.device import resolve_device


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--seqs", nargs="+", required=True)
    ap.add_argument("--cam", default="cam0")
    ap.add_argument("--pca_dim", type=int, default=128)
    ap.add_argument("--out_hw", type=int, nargs=2, default=[128, 153])
    ap.add_argument("--extractor", default="auto")
    ap.add_argument("--stride", type=int, default=7,
                    help="dense ViT extraction stride (reference stride-7 "
                         "PE interpolation, feature_extractor.py:236)")
    ap.add_argument("--keep_raw", action="store_true",
                    help="keep the pass-1 raw feature maps on disk")
    ap.add_argument("--workers", type=int, default=1,
                    help="thread-pool size for decode+extract and "
                         "project+save")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    from PIL import Image

    ext = F.build_extractor(args.extractor, stride=args.stride, device=dev)
    jobs = []
    for seq in args.seqs:
        for p in sorted(glob.glob(
                os.path.join(args.root, "2d_rect", args.cam, str(seq),
                             "*.jpg"))):
            jobs.append((seq, p))

    # pass 1: extract, stream the raw features to disk (every dense
    # pre-PCA map of a real sequence would not fit in memory) and keep a
    # bounded per-frame sample for the PCA
    per_frame = max(1, 100_000 // max(len(jobs), 1))

    def raw_path(seq, p):
        frame = os.path.splitext(os.path.basename(p))[0].split("_")[-1]
        d = os.path.join(args.root, "distillation_raw", args.cam, str(seq))
        return os.path.join(d, f"{frame}.npy"), frame

    def extract_one(job):
        seq, p = job
        img = np.asarray(Image.open(p).convert("RGB"), np.float32) / 255.0
        f = np.asarray(ext(img[None])[0], np.float32)
        rp, _ = raw_path(seq, p)
        os.makedirs(os.path.dirname(rp), exist_ok=True)
        np.save(rp, f)
        flat = f.reshape(-1, f.shape[-1])
        # a stable digest: hash() of a str is salted per interpreter
        rng = np.random.default_rng(zlib.crc32(f"{seq}/{p}".encode()))
        take = min(per_frame, len(flat))
        return flat[rng.choice(len(flat), take, replace=False)]

    samples = parallel_map(extract_one, jobs, workers=args.workers)
    mean, comps = F.pca_fit(
        torch.from_numpy(np.concatenate(samples)).to(dev), k=args.pca_dim)
    del samples

    # pass 2: read the raw maps, project, resize, save
    def save_one(job):
        seq, p = job
        rp, frame = raw_path(seq, p)
        f = torch.from_numpy(np.load(rp)[None]).to(dev)
        out_dir = os.path.join(args.root, "distillation", args.cam, str(seq))
        os.makedirs(out_dir, exist_ok=True)
        proj = F.pca_project_resize(f, mean, comps, tuple(args.out_hw))
        np.save(os.path.join(out_dir, f"{frame}.npy"),
                proj[0].cpu().numpy().astype(np.float32))
        if not args.keep_raw:
            os.remove(rp)

    parallel_map(save_one, jobs, workers=args.workers)
    print(f"wrote {len(jobs)} feature maps")


if __name__ == "__main__":
    main()
