"""Image-space SAM instance labels (reference
scripts/preprocessing/create_sam_dataset.py; the JAX package's script of
the same name).

static (:195, 451-497): automatic mask generation -> an argmax-confidence
instance map per frame -> ``2d_sam/{cam}/{seq}/{frame}.npy`` [H, W]
uint16; without SAM weights, seeded grid placeholders.

dynamic (:312-448): box prompts, box-prompted masks and video propagation
with an IoU-tracked instance registry (``video_tracking``); without the
weights the deterministic stand-ins run the same tracking ->
``2d_sam_dynamic/{cam}/{seq}/{frame}.npy`` [H, W, 2] uint16 (instance,
class).

    python -m creste_public_tpu_torch.preprocessing.create_sam_dataset \
        --root D --seqs 0 --mode static [--device cpu]
"""
from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from creste_public_tpu_torch.preprocessing import video_tracking as vt
from creste_public_tpu_torch.utils.concurrency import parallel_map
from creste_public_tpu_torch.utils.device import resolve_device


def build_mask_generator(device):
    """Real SAM automatic mask generation on ``device`` when weights
    resolve (hub cache or a local HF checkpoint dir via CRESTE_SAM_MODEL),
    else None."""
    return vt.try_load_auto_mask_generator(device=device)


def masks_to_instance_map(masks, scores, hw):
    """Overlapping masks -> argmax-confidence instance ids (reference
    create_sam_dataset.py:83-99)."""
    inst = np.zeros(hw, np.uint16)
    conf = np.zeros(hw, np.float32)
    for i, (m, s) in enumerate(sorted(
            zip(masks, scores), key=lambda t: t[1])):
        take = m & (s >= conf)
        inst[take] = i + 1
        conf[take] = s
    return inst


def placeholder_instances(img, seed=0):
    """Seeded grid labels (the static labels without SAM weights)."""
    H, W = img.shape[:2]
    rng = np.random.default_rng(seed)
    ys = np.sort(rng.choice(np.arange(1, H), 3, replace=False))
    xs = np.sort(rng.choice(np.arange(1, W), 3, replace=False))
    inst = np.zeros((H, W), np.uint16)
    label = 1
    for y0, y1 in zip([0, *ys], [*ys, H]):
        for x0, x1 in zip([0, *xs], [*xs, W]):
            inst[y0:y1, x0:x1] = label
            label += 1
    return inst


def frame_paths(root, cam, seq):
    def frame_of(p):
        return int(os.path.splitext(os.path.basename(p))[0].split("_")[-1])

    paths = sorted(glob.glob(os.path.join(root, "2d_rect", cam, str(seq),
                                          "*.jpg")), key=frame_of)
    return paths, [frame_of(p) for p in paths]


def run_static(args, seq, device):
    from PIL import Image

    gen = build_mask_generator(device)
    if gen is None:
        print("WARNING: SAM weights unavailable; writing placeholder labels")
    out_dir = os.path.join(args.root, "2d_sam", args.cam, str(seq))
    os.makedirs(out_dir, exist_ok=True)
    paths, frames = frame_paths(args.root, args.cam, seq)
    for p, frame in zip(paths, frames):
        out = os.path.join(out_dir, f"{frame}.npy")
        if os.path.exists(out):
            continue
        img = np.asarray(Image.open(p).convert("RGB"))
        if gen is not None:
            masks, scores = gen.generate(img)
            inst = masks_to_instance_map(list(masks), list(scores),
                                         img.shape[:2])
        else:
            inst = placeholder_instances(img, seed=frame)
        np.save(out, inst)
    print(f"seq {seq}: {len(paths)} static frames -> {out_dir}")


def run_dynamic(args, seq, device):
    from PIL import Image

    detector = vt.try_load_detector(device=device)
    masker = vt.try_load_mask_predictor(device=device)
    if detector is None or masker is None:
        print("WARNING: GroundingDINO/SAM weights unavailable; running the "
              "tracking algorithm over deterministic threshold blobs")
        detector = vt.FakeBlobDetector()
        masker = vt.FakeBoxMaskPredictor()
    # SAM2's video predictor is replaced by the weights-free template
    # tracker (the same VideoPropagator interface)
    propagator = vt.TemplateMaskPropagator()

    out_dir = os.path.join(args.root, "2d_sam_dynamic", args.cam, str(seq))
    os.makedirs(out_dir, exist_ok=True)
    paths, frames = frame_paths(args.root, args.cam, seq)
    if not paths:
        return
    if all(os.path.exists(os.path.join(out_dir, f"{f}.npy"))
           for f in frames):
        print(f"seq {seq}: dynamic labels already complete")
        return
    imgs = [np.asarray(Image.open(p).convert("RGB")) for p in paths]
    maps = vt.track_video(imgs, detector, masker, propagator,
                          step=args.step)
    for frame, m in zip(frames, maps):
        np.save(os.path.join(out_dir, f"{frame}.npy"), m)
    print(f"seq {seq}: {len(paths)} dynamic frames -> {out_dir}")


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--seqs", nargs="+", required=True)
    ap.add_argument("--cam", default="cam0")
    ap.add_argument("--mode", choices=["static", "dynamic"], default="static")
    ap.add_argument("--step", type=int, default=1,
                    help="dynamic: frames between re-detections")
    ap.add_argument("--workers", type=int, default=1,
                    help="thread-pool size over sequences")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    run = run_static if args.mode == "static" else run_dynamic
    parallel_map(lambda seq: run(args, seq, dev), args.seqs,
                 workers=args.workers)


if __name__ == "__main__":
    main()
