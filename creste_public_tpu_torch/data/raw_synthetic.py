"""Raw-format synthetic CODa tree: sensors only, no labels.

Counterpart of ``creste_public_tpu/data/raw_synthetic.py``: the on-disk
layout the reference documents as its raw input (README.md:78-108):
camera jpgs (``2d_rect/cam0/{seq}/``), Ouster ``.bin`` point clouds
(``3d_raw/os1/{seq}/``), per-point semantic ids (``3d_semantic/{seq}/``),
the two calibration files (``calibrations/{seq}/``), dense poses
(``poses/dense/{seq}.txt``) and timestamps. Every label family comes from
the preprocessing entry points (``creste_public_tpu_torch.preprocessing``).
The same seed writes the same bytes as the JAX package's writer; the
calibration files are written as text, without a YAML library.

One world (a bumpy ground plane, three static boxes and one moving box) is
seen by every sensor: the LiDAR samples its surfaces and the camera
z-buffers the same samples, so the labels derived from each agree.
"""
from __future__ import annotations

import os

import numpy as np

from creste_public_tpu_torch.data import coda_constants as cc

__all__ = ["write_raw_coda_tree"]


def _yaw_quat(yaw: np.ndarray) -> np.ndarray:
    """[N] yaw -> [N, 4] (qw, qx, qy, qz) about +z."""
    h = 0.5 * yaw
    return np.stack(
        [np.cos(h), np.zeros_like(h), np.zeros_like(h), np.sin(h)], -1
    )


def _trajectory(n: int, speed: float, curve: float) -> np.ndarray:
    """[N, 3] (x, y, yaw): forward arc with curvature ``curve`` rad/frame."""
    yaw = curve * np.arange(n)
    x = np.concatenate([[0.0], np.cumsum(speed * np.cos(yaw[:-1]))])
    y = np.concatenate([[0.0], np.cumsum(speed * np.sin(yaw[:-1]))])
    return np.stack([x, y, yaw], -1)


def _ground_z(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    return 0.12 * np.sin(x / 2.5) * np.cos(y / 3.5)


def _boxes(n_frames: int, scale: float = 1.0) -> np.ndarray:
    """[F, K, 4] per-frame box states (cx, cy, half, height). Boxes 0..2
    are static obstacles; box 3 translates (the dynamic object). ``scale``
    shrinks the layout with the LiDAR range so tiny-map runs keep the
    obstacles in view."""
    static = np.array(
        [[4.0, 1.5, 0.5, 1.2], [7.0, -2.0, 0.7, 0.9], [10.0, 2.5, 0.6, 1.5]]
    )
    out = np.tile(static[None], (n_frames, 1, 1))
    mov = np.stack(
        [
            5.0 + 0.08 * np.arange(n_frames),
            -1.0 + 0.05 * np.arange(n_frames),
            np.full(n_frames, 0.4),
            np.full(n_frames, 1.0),
        ],
        -1,
    )
    boxes = np.concatenate([out, mov[:, None]], axis=1)
    boxes[:, :, :3] *= scale  # positions + half-extents; keep heights
    return boxes


def _sample_world(
    rng: np.random.Generator, pose_xyyaw: np.ndarray, boxes: np.ndarray,
    n_points: int, max_range: float,
) -> tuple[np.ndarray, np.ndarray]:
    """Sample world-frame surface points visible from the robot.

    Returns (xyz_world [N, 3], surf_id [N] — 0 ground, 1+k box k)."""
    px, py, yaw = pose_xyyaw
    n_ground = int(n_points * 0.8)
    n_box = n_points - n_ground

    az = rng.uniform(-np.pi, np.pi, n_ground)
    rr = rng.uniform(0.8, max_range, n_ground)
    gx = px + rr * np.cos(az + yaw)
    gy = py + rr * np.sin(az + yaw)
    ground = np.stack([gx, gy, _ground_z(gx, gy)], -1)

    k = boxes.shape[0]
    bi = rng.integers(0, k, n_box)
    b = boxes[bi]
    side = rng.integers(0, 5, n_box)  # 4 walls + top
    u = rng.uniform(-1, 1, n_box)
    v = rng.uniform(0, 1, n_box)
    bx = np.where(side == 0, b[:, 2], np.where(side == 1, -b[:, 2],
                  u * b[:, 2]))
    by = np.where(side == 2, b[:, 2], np.where(side == 3, -b[:, 2],
                  np.where(side < 2, u * b[:, 2], u * b[:, 2])))
    bz = np.where(side == 4, b[:, 3], v * b[:, 3])
    box_pts = np.stack([b[:, 0] + bx, b[:, 1] + by,
                        _ground_z(b[:, 0], b[:, 1]) + bz], -1)

    xyz = np.concatenate([ground, box_pts], 0)
    sid = np.concatenate([np.zeros(n_ground, np.int64), 1 + bi], 0)
    return xyz, sid


def _pose_matrix(pose_xyyaw: np.ndarray, z: float) -> np.ndarray:
    x, y, yaw = pose_xyyaw
    c, s = np.cos(yaw), np.sin(yaw)
    T = np.eye(4)
    T[:2, :2] = [[c, -s], [s, c]]
    T[:3, 3] = [x, y, z]
    return T


def _yaml_float(x: float) -> str:
    """A float as YAML 1.1 reads it back (PyYAML wants a '.' in an
    exponent form)."""
    s = repr(float(x))
    if "e" in s and "." not in s.split("e")[0]:
        m, e = s.split("e")
        s = f"{m}.0e{e}"
    return s


def _yaml_matrix(name: str, rows: int, cols: int, data) -> str:
    vals = ", ".join(_yaml_float(v) for v in data)
    return f"{name}:\n  rows: {rows}\n  cols: {cols}\n  data: [{vals}]\n"


def _calib_yamls(cal_dir: str, H: int, W: int) -> np.ndarray:
    """Write the two calibration files (YAML text that ``yaml.safe_load``
    and the port's ``data.calib`` reader read to the same values); returns
    lidar2camrect [4, 4]."""
    fx = 0.9 * W
    K = [fx, 0.0, W / 2.0, 0.0, fx, H / 2.0, 0.0, 0.0, 1.0]
    P = [fx, 0.0, W / 2.0, 0.0, 0.0, fx, H / 2.0, 0.0, 0.0, 0.0, 1.0, 0.0]
    with open(os.path.join(cal_dir, "calib_cam0_intrinsics.yaml"), "w") as f:
        f.write(_yaml_matrix("camera_matrix", 3, 3, K)
                + _yaml_matrix("rectification_matrix", 3, 3,
                               [1, 0, 0, 0, 1, 0, 0, 0, 1])
                + _yaml_matrix("projection_matrix", 3, 4, P)
                + f"image_height: {H}\nimage_width: {W}\n")
    # lidar (x fwd, y left, z up) -> camera (z fwd, x right, y down),
    # camera 0.3 m above the lidar origin
    l2c = np.array(
        [[0, -1, 0, 0], [0, 0, -1, 0.3], [1, 0, 0, 0]], np.float64
    )
    Pm = np.asarray(P, np.float64).reshape(3, 4)
    l2c_h = np.vstack([l2c, [0, 0, 0, 1]])
    l2r = Pm @ l2c_h
    with open(os.path.join(cal_dir, "calib_os1_to_cam0.yaml"), "w") as f:
        f.write(_yaml_matrix("extrinsic_matrix", 3, 4, l2c.reshape(-1))
                + _yaml_matrix("projection_matrix", 3, 4, l2r.reshape(-1)))
    return np.vstack([l2r, [0, 0, 0, 1]])


_SURF_COLORS = np.array(
    [[96, 120, 72], [200, 60, 60], [60, 90, 200], [220, 180, 40],
     [150, 60, 160]],
    np.float64,
)


def _render_image(
    xyz_lidar: np.ndarray, sid: np.ndarray, l2r: np.ndarray,
    H: int, W: int,
) -> np.ndarray:
    """Z-buffered splat of the colored scan into the camera — the camera
    sees the same world the LiDAR samples."""
    p = np.concatenate([xyz_lidar, np.ones((len(xyz_lidar), 1))], -1)
    uvw = p @ l2r.T
    z = uvw[:, 2]
    ok = z > 0.1
    u = np.round(uvw[ok, 0] / z[ok]).astype(np.int64)
    v = np.round(uvw[ok, 1] / z[ok]).astype(np.int64)
    inb = (u >= 0) & (u < W) & (v >= 0) & (v < H)
    u, v, zz = u[inb], v[inb], z[ok][inb]
    cols = _SURF_COLORS[np.minimum(sid[ok][inb], len(_SURF_COLORS) - 1)]
    # background: sky-to-ground vertical gradient
    img = np.linspace(170, 90, H)[:, None, None] * np.ones((1, W, 3))
    flat = v * W + u
    order = np.argsort(-zz)  # nearest last -> wins
    img.reshape(-1, 3)[flat[order]] = cols[order]
    # 2x2 dilation fills sampling holes deterministically
    img2 = img.copy()
    img2[1:] = np.maximum(img2[1:], img[:-1])
    img2[:, 1:] = np.maximum(img2[:, 1:], img[:, :-1])
    return np.clip(img2, 0, 255).astype(np.uint8)


def write_raw_coda_tree(
    root: str,
    seq: str = "0",
    n_frames: int = 24,
    img_hw: tuple[int, int] = (64, 80),
    points_per_scan: int = 4096,
    speed: float = 0.35,
    curve: float = 0.02,
    max_range: float = 14.0,
    seed: int = 0,
) -> dict:
    """Write the raw sensor tree; returns a manifest of what was written."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    H, W = img_hw
    seq = str(seq)

    cal_dir = os.path.join(root, cc.CALIBRATION_DIR, seq)
    img_dir = os.path.join(root, cc.CAMERA_DIR, "cam0", seq)
    pc_dir = os.path.join(root, cc.POINTCLOUD_DIR, cc.DEFAULT_LIDAR, seq)
    pose_dir = os.path.join(root, cc.POSES_DIR, "dense")
    ts_dir = os.path.join(root, cc.TIMESTAMPS_DIR)
    # per-point semantic annotations ship WITH the raw CODa release (the
    # reference's build_feature_map consumes them as input, never produces
    # them), so the raw fixture emits them too: surface id per LiDAR point
    sem_dir = os.path.join(root, "3d_semantic", seq)
    for d in (cal_dir, img_dir, pc_dir, pose_dir, ts_dir, sem_dir):
        os.makedirs(d, exist_ok=True)

    l2r = _calib_yamls(cal_dir, H, W)
    traj = _trajectory(n_frames, speed, curve)
    boxes = _boxes(n_frames, scale=max_range / 14.0)
    lidar_h = 0.5  # sensor height above local ground

    rows = np.zeros((n_frames, 8))
    for i in range(n_frames):
        z = _ground_z(traj[i, 0:1], traj[i, 1:2])[0] + lidar_h
        rows[i, 0] = 0.1 * i  # ts
        rows[i, 1:4] = [traj[i, 0], traj[i, 1], z]
        rows[i, 4:8] = _yaw_quat(traj[i, 2:3])[0]

        T = _pose_matrix(traj[i], z)
        xyz_w, sid = _sample_world(
            rng, traj[i], boxes[i], points_per_scan, max_range=max_range
        )
        Tinv = np.linalg.inv(T)
        xyz_l = (
            np.concatenate([xyz_w, np.ones((len(xyz_w), 1))], -1) @ Tinv.T
        )[:, :3]
        scan = np.zeros((points_per_scan, cc.OUSTER_FEATURES), np.float32)
        scan[:, :3] = xyz_l
        scan[:, 3] = rng.uniform(0, 1, points_per_scan)  # intensity
        if cc.OUSTER_FEATURES > 4:
            scan[:, 4] = np.arange(points_per_scan) % 128  # ring
        scan.tofile(
            cc.frame_path(root, cc.POINTCLOUD_DIR, cc.DEFAULT_LIDAR, seq,
                          i, "bin")
        )
        # CODa-style per-point semantic ids (ground=1, obstacles=2+)
        (sid.astype(np.uint32) + 1).tofile(
            os.path.join(sem_dir, f"{i}.bin")
        )

        img = _render_image(xyz_l, sid, l2r, H, W)
        Image.fromarray(img).save(
            cc.frame_path(root, cc.CAMERA_DIR, "cam0", seq, i, "jpg"),
            quality=92,
        )

    np.savetxt(os.path.join(pose_dir, f"{seq}.txt"), rows)
    np.savetxt(os.path.join(ts_dir, f"{seq}.txt"), rows[:, 0])
    return {
        "root": root, "seq": seq, "n_frames": n_frames, "img_hw": img_hw,
        "points_per_scan": points_per_scan,
    }
