"""CLI: mini-release packager (reference: scripts/release/package_data.py;
a copy of the JAX package's script of the same name with the port's CODa
constants). Collects the frames in a window around each
counterfactual-annotated sample into a tar.gz that keeps the CODa layout.
Host only: it reads and writes files and runs nothing on a device.

    python -m creste_public_tpu_torch.release.package_data --root D \\
        [--out creste_mini_release.tar.gz] [--window 5]
"""
from __future__ import annotations

import argparse
import glob
import os
import tarfile

from creste_public_tpu_torch.data import coda_constants as cc

# (directory under the root, extension, whether the file name is the
# modality_sensor_seq_frame codec)
FRAME_DIRS = [
    (f"{cc.CAMERA_DIR}/{cc.DEFAULT_CAM}", "jpg", True),
    (f"{cc.POINTCLOUD_DIR}/{cc.DEFAULT_LIDAR}", "bin", True),
    (f"{cc.DISTILLATION_LABEL_DIR}/{cc.DEFAULT_CAM}", "npy", False),
    (cc.SAM_LABEL_DIR, "npy", False),
    (cc.SAM_DYNAMIC_LABEL_DIR, "npy", False),
    (cc.ELEVATION_LABEL_DIR, "npy", False),
    (cc.COUNTERFACTUAL_LABEL_DIR, "pkl", False),
]
META_DIRS = [cc.CALIBRATION_DIR, cc.POSES_DIR, cc.SPLITS_DIR,
             cc.TRAVERSE_LABEL_DIR]


def frame_files(root: str, subdir: str, seq: str, frame: int, ext: str,
                codec: bool) -> list[str]:
    if codec:
        mod, sensor = subdir.split("/")
        return [cc.frame_path(root, mod, sensor, seq, frame, ext)]
    return [os.path.join(root, subdir, str(seq), f"{frame}.{ext}")]


def picked_frames(root: str, window: int) -> list[tuple[str, int]]:
    """The (seq, frame) pairs within ``window`` frames of a
    counterfactual pickle, sorted."""
    picked = set()
    for pkl in glob.glob(os.path.join(root, cc.COUNTERFACTUAL_LABEL_DIR, "*",
                                      "*.pkl")):
        seq = os.path.basename(os.path.dirname(pkl))
        frame = int(os.path.splitext(os.path.basename(pkl))[0])
        picked.update((seq, f) for f in range(frame - window,
                                              frame + window + 1))
    return sorted(picked)


def package(root: str, out: str, window: int = 5) -> int:
    """Writes the archive; returns the number of frame files in it."""
    picked = picked_frames(root, window)
    print(f"{len(picked)} (seq, frame) pairs around counterfactual samples")
    n = 0
    with tarfile.open(out, "w:gz") as tar:
        for d in META_DIRS:
            p = os.path.join(root, d)
            if os.path.isdir(p):
                tar.add(p, arcname=d)
        for seq, frame in picked:
            for subdir, ext, codec in FRAME_DIRS:
                for path in frame_files(root, subdir, seq, frame, ext, codec):
                    if os.path.exists(path):
                        tar.add(path, arcname=os.path.relpath(path, root))
                        n += 1
        # depth label dirs (any generated variant)
        for ddir in glob.glob(os.path.join(root, "depth_*")):
            for seq, frame in picked:
                for path in glob.glob(
                        os.path.join(ddir, "*", str(seq), f"{frame}.png")):
                    tar.add(path, arcname=os.path.relpath(path, root))
                    n += 1
    print(f"packaged {n} frame files -> {out}")
    return n


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--out", default="creste_mini_release.tar.gz")
    ap.add_argument("--window", type=int, default=5,
                    help="frames around each counterfactual sample")
    args = ap.parse_args(argv)
    return package(args.root, args.out, args.window)


if __name__ == "__main__":
    main()
