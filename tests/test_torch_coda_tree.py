"""A synthesized UT CODa directory tree for the port's CODa tests and for
``chip_smoke.py`` (no tests of its own; imports neither JAX nor YAML, so
that the card's machine can load it by its path).

``write_coda_tree`` writes, for each sequence, ``frames`` frames of:
JPEG images (``2d_rect``), 16-bit PNG depth (``depth_5_LA_all``), DINO
features (``distillation``), static and dynamic SAM maps, elevation (the
``.bin`` of the reference's contract, or the legacy ``.npy``), optionally
the SSC/SOC/FSC bins, Ouster scans and the two movability masks, one
counterfactual pickle per frame, the dense poses, and the two calibration
files in the block style ``yaml.safe_dump`` writes or in the ROS flow
style (a ``data: [...]`` list over three lines, with comments). Splits:
``train``, ``val`` and ``train_distances``; ``partial`` lists the one
frame written without its static SAM map (``missing_sam``).
"""
from __future__ import annotations

import os
import pickle

import numpy as np
from PIL import Image

CAM, LIDAR = "cam0", "os1"
N_SEM_RAW, N_OBJ_RAW = 25, 60


def calibration(H: int, W: int) -> dict:
    """Pinhole intrinsics at ``H x W`` and the LiDAR -> camera extrinsic
    (x forward, y left, z up -> the camera's z, -x, -y)."""
    f = 0.9 * W
    K = [f, 0.0, W / 2, 0.0, f, H / 2, 0.0, 0.0, 1.0]
    P = [f, 0.0, W / 2, 0.0, 0.0, f, H / 2, 0.0, 0.0, 0.0, 1.0, 0.0]
    l2c = [0.0, -1.0, 0.0, 0.02, 0.0, 0.0, -1.0, -0.1, 1.0, 0.0, 0.0, 0.05]
    l2c_m = np.vstack([np.reshape(l2c, (3, 4)), [0, 0, 0, 1]])
    l2r = (np.reshape(P, (3, 4)) @ l2c_m).reshape(-1).tolist()
    return {
        "intrinsics": {
            "camera_matrix": {"rows": 3, "cols": 3, "data": K},
            "rectification_matrix": {
                "rows": 3, "cols": 3,
                "data": [1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0]},
            "projection_matrix": {"rows": 3, "cols": 4, "data": P},
            "image_height": H, "image_width": W,
        },
        "extrinsics": {
            "extrinsic_matrix": {"rows": 3, "cols": 4, "data": l2c},
            "projection_matrix": {"rows": 3, "cols": 4, "data": l2r},
        },
    }


def _scalar(v) -> str:
    return repr(float(v)) if isinstance(v, float) else str(v)


def block_style(doc: dict) -> str:
    """``doc`` as ``yaml.safe_dump`` writes it: sorted keys, block
    mappings, unindented block sequences."""
    lines = []
    for k in sorted(doc):
        v = doc[k]
        if isinstance(v, dict):
            lines.append(f"{k}:")
            for kk in sorted(v):
                vv = v[kk]
                if isinstance(vv, list):
                    lines.append(f"  {kk}:")
                    lines += [f"  - {_scalar(x)}" for x in vv]
                else:
                    lines.append(f"  {kk}: {_scalar(vv)}")
        else:
            lines.append(f"{k}: {_scalar(v)}")
    return "\n".join(lines) + "\n"


def ros_style(doc: dict) -> str:
    """``doc`` as ROS camera-info files are written: rows, cols, then a
    flow list of data over three lines, with comments."""
    lines = ["# written by the calibration tool"]
    for k, v in doc.items():
        if isinstance(v, dict):
            lines.append(f"{k}:  # {v['rows']}x{v['cols']}")
            lines.append(f"  rows: {v['rows']}")
            lines.append(f"  cols: {v['cols']}")
            data = [f"{x:.9e}" for x in v["data"]]
            third = -(-len(data) // 3)
            chunks = [", ".join(data[i:i + third])
                      for i in range(0, len(data), third)]
            lines.append("  data: [ " + (",\n          ").join(chunks) + " ]")
        else:
            lines.append(f"{k}: {_scalar(v)}")
    return "\n".join(lines) + "\n"


def poses(n: int) -> np.ndarray:
    """[n, 8] dense pose rows ``ts x y z qw qx qy qz``: a slow curve that
    turns 10 degrees a frame, so that frames two and more apart overlap
    their FOV in (0.1, 0.8)."""
    rows = []
    for i in range(n):
        yaw = np.deg2rad(10.0 * i)
        rows.append([0.1 * i, 0.05 * i, 0.01 * i * i, 0.0,
                     np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2)])
    return np.asarray(rows)


def write_coda_tree(root: str, seqs=("0", "1"), frames: int = 6,
                    H: int = 64, W: int = 80, grid: int = 32,
                    fdim: int = 16, ds: int = 4, styles=("block", "ros"),
                    legacy_elevation=("1",), labels3d: bool = True,
                    scans: bool = True, movability: bool = True,
                    missing_sam: str | None = "1", feat_hw=None,
                    seed: int = 0, pool=None) -> dict:
    """Writes the tree under ``root``; returns ``{"train": [(seq, frame)],
    "val": [...], "partial": [...]}``: each sequence's last frame is
    ``val``, the others ``train``. Sequence ``missing_sam`` gets one frame
    more, written without its static SAM map and listed only in
    ``partial``. The DINO features are ``feat_hw`` (default the frame's
    size over ``ds``: set it to the feature size of a resized frame).
    ``pool`` (an executor, or None) encodes the JPEG and PNG files: the
    same bytes, written while the next frame is drawn."""
    rng = np.random.default_rng(seed)
    saves = []

    def save(image, path: str, **kw) -> None:
        if pool is None:
            image.save(path, **kw)
        else:
            saves.append(pool.submit(image.save, path, **kw))

    hs, ws = feat_hw or (-(-H // ds), -(-W // ds))
    cal = calibration(H, W)
    splits: dict[str, list] = {"train": [], "val": [], "partial": []}
    for si, seq in enumerate(seqs):
        n = frames + (seq == missing_sam)
        style = styles[si % len(styles)]
        write = block_style if style == "block" else ros_style
        cal_dir = os.path.join(root, "calibrations", seq)
        os.makedirs(cal_dir, exist_ok=True)
        with open(os.path.join(cal_dir, f"calib_{CAM}_intrinsics.yaml"),
                  "w") as f:
            f.write(write(cal["intrinsics"]))
        with open(os.path.join(cal_dir, f"calib_os1_to_{CAM}.yaml"),
                  "w") as f:
            f.write(write(cal["extrinsics"]))
        pose_dir = os.path.join(root, "poses", "dense")
        os.makedirs(pose_dir, exist_ok=True)
        np.savetxt(os.path.join(pose_dir, f"{seq}.txt"), poses(n))

        def sub(*parts):
            d = os.path.join(root, *parts)
            os.makedirs(d, exist_ok=True)
            return d

        for fr in range(n):
            u = np.linspace(0, 1, W)[None, :, None]
            v = np.linspace(0, 1, H)[:, None, None]
            rgb = (0.5 * rng.uniform(0, 255, (H, W, 3))
                   + 60 * (u + v) + 20 * fr)
            save(Image.fromarray(np.clip(rgb, 0, 255).astype(np.uint8)),
                 os.path.join(sub("2d_rect", CAM, seq),
                              f"2d_rect_{CAM}_{seq}_{fr}.jpg"), quality=90)
            depth = rng.uniform(300, 20000, (H, W))
            depth[rng.uniform(size=(H, W)) < 0.5] = 0
            save(Image.fromarray(depth.astype(np.uint16)),
                 os.path.join(sub("depth_5_LA_all", CAM, seq), f"{fr}.png"))
            np.save(os.path.join(sub("distillation", CAM, seq), f"{fr}.npy"),
                    rng.normal(size=(hs, ws, fdim)).astype(np.float32))
            sam = np.kron(rng.integers(0, 40, (grid // 4, grid // 4)),
                          np.ones((4, 4), np.int64)).astype(np.uint16)
            partial = fr == frames
            if not partial:
                np.save(os.path.join(sub("3d_sam", seq), f"{fr}.npy"), sam)
            dyn = np.stack([rng.integers(0, 6, (grid, grid)),
                            rng.integers(0, 6, (grid, grid)),
                            rng.integers(0, 2, (grid, grid))], -1)
            dyn[rng.uniform(size=(grid, grid)) < 0.8] = 0
            np.save(os.path.join(sub("3d_sam_dynamic", seq), f"{fr}.npy"),
                    dyn.astype(np.uint16))
            lo = rng.normal(scale=0.1, size=(grid, grid)).astype(np.float32)
            elev = np.stack([lo, lo + np.abs(rng.normal(
                scale=0.3, size=(grid, grid))).astype(np.float32)], -1)
            if seq in legacy_elevation:
                np.save(os.path.join(sub("elevation", seq), f"{fr}.npy"),
                        np.moveaxis(elev, -1, 0))
            else:
                elev.astype(np.float32).tofile(
                    os.path.join(sub("elevation", seq), f"{fr}.bin"))
            if labels3d:
                rng.integers(0, 3, (grid, grid, N_SEM_RAW)).astype(
                    np.int64).tofile(os.path.join(sub("3d_ssc", seq),
                                                  f"{fr}.bin"))
                rng.integers(0, 3, (grid, grid, N_OBJ_RAW)).astype(
                    np.uint16).tofile(os.path.join(sub("3d_soc", seq),
                                                   f"{fr}.bin"))
                rng.normal(size=(grid, grid, 4)).astype(np.float32).tofile(
                    os.path.join(sub("3d_fsc", seq), f"{fr}.bin"))
            if scans:
                rng.normal(scale=5.0, size=(500 + 37 * fr, 4)).astype(
                    np.float32).tofile(os.path.join(
                        sub("3d_raw", LIDAR, seq),
                        f"3d_raw_{LIDAR}_{seq}_{fr}.bin"))
                (rng.uniform(size=500 + 37 * fr) < 0.7).tofile(os.path.join(
                    sub("3d_comp_movability", LIDAR, seq), f"{fr}.bin"))
            if movability and fr % 2 == 0:
                mv = np.zeros((H, W, 2), np.int32)
                mv[H // 3:H // 2, W // 4:W // 2, 0] = 1 + fr
                np.save(os.path.join(sub("2d_sam_dynamic", CAM, seq),
                                     f"{fr}.npy"), mv)
            k = int(rng.integers(1, 8))
            with open(os.path.join(sub("counterfactuals", seq), f"{fr}.pkl"),
                      "wb") as f:
                pickle.dump({
                    "trajectories": [
                        rng.uniform(0, grid, (int(rng.integers(3, 60)), 3))
                        for _ in range(k)],
                    "rank": list(range(k))}, f)
            split = ("partial" if partial
                     else "val" if fr == frames - 1 else "train")
            splits[split].append((seq, fr))
    split_dir = os.path.join(root, "splits")
    os.makedirs(split_dir, exist_ok=True)
    for name, rows in splits.items():
        with open(os.path.join(split_dir, f"{name}.txt"), "w") as f:
            f.writelines(f"{s} {fr}\n" for s, fr in rows)
    np.savetxt(os.path.join(split_dir, "train_distances.txt"),
               rng.uniform(0, 5, len(splits["train"])))
    for job in saves:
        job.result()
    return splits
