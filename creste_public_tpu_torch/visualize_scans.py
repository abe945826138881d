"""CLI: scan viewer over a CODa tree (LaserScanVis analog).

The counterpart of ``scripts/visualize_scans.py``. The reference's
``creste/utils/pointcloud_vis.py`` runs as a vispy window over a
sequence's scans (:101 LaserScanVis; N/B keys step frames); here the
interactive surface is one self-contained HTML file
(``utils.pointcloud_vis.export_html_viewer``: a software z-buffer splat in
the browser, nothing to install): point it at a dataset root and sequence,
and open the output in any browser. With ``--png DIR`` it also renders
each scan to ``DIR/<frame>.png`` through ``PointCloudFigure``, whose
z-buffer runs on ``--device`` (the card unless ``--device cpu``).

    python -m creste_public_tpu_torch.visualize_scans --root D --seq 0 \\
        [--frames 0 10 20] [--out scans.html] [--labels 3d_semantic] \\
        [--point-size 2] [--png DIR] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from creste_public_tpu_torch.data import coda_constants as cc
from creste_public_tpu_torch.utils.device import resolve_device
from creste_public_tpu_torch.utils.pointcloud_vis import (
    export_html_viewer,
    render_scan,
)


def read_scans(root: str, seq: str, frames: list[int] | None,
               labels: str | None):
    """(frames, scans [N, 4] xyz + intensity, per-point labels or None) of
    one sequence; the first 10 scans when ``frames`` is None."""
    pc_dir = os.path.join(root, cc.POINTCLOUD_DIR, cc.DEFAULT_LIDAR, str(seq))
    if frames is None:
        names = sorted(f for f in os.listdir(pc_dir) if f.endswith(".bin"))
        frames = [cc.parse_frame(n) for n in names[:10]]
    scans, labs = [], []
    for fr in frames:
        path = cc.frame_path(root, cc.POINTCLOUD_DIR, cc.DEFAULT_LIDAR,
                             str(seq), fr, "bin")
        pts = np.fromfile(path, np.float32).reshape(-1, cc.OUSTER_FEATURES)
        scans.append(pts[:, :4])
        lab = None
        if labels:
            lp = os.path.join(root, labels, str(seq), f"{fr}.bin")
            if os.path.exists(lp):
                lab = np.fromfile(lp, np.uint32)[: len(pts)]
        labs.append(lab)
    return frames, scans, labs


def main(argv: list[str] | None = None) -> str:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--seq", default="0")
    ap.add_argument("--frames", type=int, nargs="*", default=None,
                    help="frame ids (default: first 10)")
    ap.add_argument("--out", default="scans.html")
    ap.add_argument("--labels", default=None,
                    help="per-point label dir (e.g. 3d_semantic) for the "
                         "label color mode")
    ap.add_argument("--point-size", type=int, default=2)
    ap.add_argument("--png", default=None,
                    help="also render each scan to DIR/<frame>.png")
    ap.add_argument("--device", default="cuda",
                    help="where the PNG renders' z-buffer runs")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    frames, scans, labels = read_scans(args.root, args.seq, args.frames,
                                       args.labels)
    out = export_html_viewer(
        args.out, scans, labels=labels, point_size=args.point_size,
        title=f"seq {args.seq} ({len(scans)} scans)",
    )
    print(f"wrote {out} ({os.path.getsize(out) / 1e6:.1f} MB): open in "
          f"any browser; N/B step scans, C cycles color modes")
    if args.png:
        for fr, scan in zip(frames, scans):
            render_scan(scan, os.path.join(args.png, f"{fr}.png"),
                        device=device, size=args.point_size ** 2)
        print(f"rendered {len(frames)} scans to {args.png}")
    return out


if __name__ == "__main__":
    main()
