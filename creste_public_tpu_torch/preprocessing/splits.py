"""Split generation + traversability start-frame filtering.

Counterpart of ``creste_public_tpu/preprocessing/splits.py`` (host NumPy
and scipy's ``directed_hausdorff``). Parity targets:
  - scripts/preprocessing/build_splits.py:70-245 — per-task frame-set
    intersection, curvature classification by Hausdorff distance between
    the driven path and its straight-line chord, 70/15/15 train/val/test.
  - scripts/preprocessing/create_traversability_dataset.py:40-98 —
    valid expert-demo starts: the robot moves >= dist_thresh over
    ``num_frames`` future frames and ends up in front of where it started.

All pure NumPy (host-side, file-free core functions + I/O wrappers).
"""
from __future__ import annotations

import os
from typing import Iterable, Sequence

import numpy as np

from creste_public_tpu_torch.data.calib import poses_to_matrices


def hausdorff_to_chord(xy: np.ndarray) -> float:
    """Symmetric Hausdorff distance between a path and its straight chord."""
    from scipy.spatial.distance import directed_hausdorff

    chord = np.linspace(xy[0], xy[-1], len(xy))
    return max(
        directed_hausdorff(xy, chord)[0], directed_hausdorff(chord, xy)[0]
    )


def path_window_xy(pose_mats: np.ndarray, start: int, horizon: int) -> np.ndarray:
    """Ego-relative xy track over [start, start+horizon)."""
    window = pose_mats[start : start + horizon]
    rel = np.linalg.inv(window[0]) @ window
    return rel[:, :2, 3]


def classify_curvature(
    pose_mats: np.ndarray,
    frames: Iterable[int],
    horizon: int = 100,
    min_distance: float = 3.0,
    curved_threshold: float = 0.5,
) -> tuple[list[int], list[int], dict[int, float]]:
    """Split frames into (curved, straight) by chord-Hausdorff distance;
    frames without enough travel/lookahead are dropped
    (build_splits.py:118-193)."""
    curved, straight, dists = [], [], {}
    n = len(pose_mats)
    for f in frames:
        if f + horizon > n:
            continue
        xy = path_window_xy(pose_mats, f, horizon)
        if xy[-1, 0] < xy[0, 0]:  # must end up in front
            continue
        if np.linalg.norm(xy[-1] - xy[0]) < min_distance:
            continue
        d = hausdorff_to_chord(xy)
        dists[f] = d
        (curved if d > curved_threshold else straight).append(f)
    return curved, straight, dists


def train_val_test(
    samples: Sequence, fractions=(0.7, 0.15, 0.15), seed: int = 0
) -> dict[str, list]:
    """Shuffled 70/15/15 partition + 'full' (build_splits.py:195-245)."""
    samples = list(samples)
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(samples))
    n_train = int(fractions[0] * len(samples))
    n_val = int(fractions[1] * len(samples))
    idx = {
        "train": order[:n_train],
        "val": order[n_train : n_train + n_val],
        "test": order[n_train + n_val :],
    }
    out = {k: [samples[i] for i in v] for k, v in idx.items()}
    out["full"] = samples
    return out


def intersect_task_frames(frame_sets: dict[str, set]) -> set:
    """Frames present in every task label dir (build_splits.py:70-116)."""
    sets = list(frame_sets.values())
    if not sets:
        return set()
    out = set(sets[0])
    for s in sets[1:]:
        out &= s
    return out


def traversability_starts(
    pose_rows: np.ndarray,
    num_frames: int = 50,
    skip: int = 1,
    dist_thresh: float = 2.0,
) -> np.ndarray:
    """Valid expert start frames: displacement >= dist_thresh over
    num_frames and forward-facing end pose
    (create_traversability_dataset.py:40-98)."""
    mats = poses_to_matrices(pose_rows)
    n = len(mats)
    starts = np.arange(0, n - num_frames, skip)
    if len(starts) == 0:
        return starts
    rel = np.linalg.inv(mats[starts]) @ mats[starts + num_frames]
    disp = np.linalg.norm(rel[:, :2, 3], axis=1)
    # end heading stays within +-90 deg of the start heading (x fwd)
    forward = rel[:, 0, 0] > 0
    return starts[(disp >= dist_thresh) & forward]


def write_split_files(
    out_dir: str, splits: dict[str, list], distances: dict | None = None
) -> None:
    os.makedirs(out_dir, exist_ok=True)
    for name, rows in splits.items():
        with open(os.path.join(out_dir, f"{name}.txt"), "w") as f:
            for r in rows:
                f.write(f"{r[0]} {r[1]}\n" if isinstance(r, tuple) else f"{r}\n")
        if distances:
            with open(
                os.path.join(out_dir, f"{name}_distances.txt"), "w"
            ) as f:
                for r in rows:
                    # distances are keyed (seq, frame): frame-only keys
                    # collide across sequences (accepted as legacy fallback)
                    if isinstance(r, tuple):
                        d = distances.get((r[0], r[1]),
                                          distances.get(r[1], 0.0))
                    else:
                        d = distances.get(r, 0.0)
                    f.write(f"{d:.4f}\n")


def drop_overlapping_horizons(
    samples: list[tuple[str, int]], horizon: int
) -> list[tuple[str, int]]:
    """Greedy per-sequence thinning: keep a (seq, frame) sample only if its
    ``horizon``-frame window does not overlap the previously kept one.

    Reference-exact (creste/utils/utils.py:125-160, pinned by the exec
    golden): rows are lexsorted by (int(seq), frame) and the kept rows are
    returned in that sorted order — the reference returns
    ``finfos[sort_idx[keep]]``, not the input order. The first frame of each
    sequence is always kept.
    """

    def seq_key(s):
        # totally ordered even for a mix of numeric and named sequences
        # (int < str comparison would raise); numeric ids sort numerically
        s = str(s)
        if s.lstrip("-").isdigit():
            return (0, int(s), "")
        return (1, 0, s)

    order = sorted(range(len(samples)),
                   key=lambda i: (seq_key(samples[i][0]), int(samples[i][1])))
    out = []
    last: dict[str, int] = {}
    for i in order:
        seq, frame = str(samples[i][0]), int(samples[i][1])
        if seq not in last or frame - last[seq] >= horizon:
            out.append(samples[i])
            last[seq] = frame
    return out
