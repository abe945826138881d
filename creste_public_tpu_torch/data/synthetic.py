"""Deterministic procedural mini-dataset with the CODa tensor contract.

A numpy copy of ``creste_public_tpu/data/synthetic.py`` (``SyntheticCodaDataset``
and ``collate``), so that the port can make realistic batches (expert arcs,
counterfactuals, FOV masks) where JAX is not installed. Every sample carries
the keys and shapes of the CODa reader, generated from a seeded procedural
scene (ground plane + boxes). Shapes are NHWC and statically padded
(counterfactuals -> fixed [N_max, T, 2] + rank + validity mask).
"""
from __future__ import annotations

from typing import Any

import numpy as np

from creste_public_tpu_torch.utils import geometry as geo


class SyntheticCodaDataset:
    def __init__(
        self,
        cfg: Any | None = None,
        length: int = 32,
        image_size=(512, 612),
        ds: int = 4,
        grid: int = 256,
        map_range: float = 12.8,
        fdn_dim: int = 128,
        sam_classes: int = 24,
        dyn_classes: int = 6,
        horizon: int = 50,
        n_cf: int = 6,
        seed: int = 0,
    ):
        if cfg is not None:
            image_size = tuple(cfg.get("image_size", image_size))
            length = int(cfg.get("length", length))
            fdn_dim = int(cfg.get("fdn_dim", fdn_dim))
            grid = int(cfg.get("grid", grid))
            map_range = float(cfg.get("map_range", map_range))
            horizon = int(cfg.get("horizon", horizon))
            ds = int(cfg.get("ds", ds))
        self.length = length
        self.h, self.w = image_size
        self.ds = ds
        self.grid = grid
        self.map_range = map_range
        self.fdn = fdn_dim
        self.sam_classes = sam_classes
        self.dyn_classes = dyn_classes
        self.horizon = horizon
        self.n_cf = n_cf
        self.seed = seed

        # pinhole + camera->lidar rotation shared across frames
        fx = fy = 0.9 * self.w
        self.K = np.array(
            [[fx, 0, self.w / 2], [0, fy, self.h / 2], [0, 0, 1.0]]
        )
        self.R_cl = np.array([[0, 0, 1.0], [-1, 0, 0], [0, -1, 0]])  # cam->lidar
        self.cam_height = 0.8

        fov = geo.create_trapezoidal_fov_mask(grid, grid, 70, 70, 0, 100)
        self.fov_mask = fov

    def __len__(self) -> int:
        return self.length

    def p2p(self, ds: int | None = None) -> np.ndarray:
        """Pixel->point matrix at feature downsample ``ds`` (intrinsics
        scaled like codapefree_dataloader.py:803-841)."""
        ds = ds or self.ds
        Ks = self.K.copy()
        Ks[:2] /= ds
        M = np.eye(4, dtype=np.float32)
        M[:3, :3] = (self.R_cl @ np.linalg.inv(Ks)).astype(np.float32)
        M[2, 3] = 0.0
        return M

    def _scene_depth(self, rng, H, W, K):
        """Ray-cast a ground plane at z=-cam_height with a few box walls."""
        u, v = np.meshgrid(np.arange(W) + 0.5, np.arange(H) + 0.5)
        rays = np.stack([u, v, np.ones_like(u)], -1) @ np.linalg.inv(K).T
        rays_l = rays @ self.R_cl.T  # lidar frame: x fwd, y left, z up
        # ground plane
        dz = rays_l[..., 2]
        t_ground = np.where(dz < -1e-6, -self.cam_height / dz, np.inf)
        depth_cam = t_ground * rays[..., 2]  # z-depth in camera frame
        # box walls: vertical planes x = d for random distances
        for _ in range(3):
            d = rng.uniform(min(3.0, 0.45 * self.map_range), 0.9 * self.map_range)
            y0 = rng.uniform(-6, 2)
            y1 = y0 + rng.uniform(1, 4)
            dx = rays_l[..., 0]
            t_wall = np.where(dx > 1e-6, d / dx, np.inf)
            y_at = t_wall * rays_l[..., 1]
            z_at = t_wall * rays_l[..., 2]
            hit = (y_at > y0) & (y_at < y1) & (z_at > -self.cam_height) & (z_at < 1.5)
            t_wall = np.where(hit, t_wall, np.inf)
            depth_cam = np.minimum(depth_cam, t_wall * rays[..., 2])
        depth_cam = np.clip(np.nan_to_num(depth_cam, posinf=0.0), 0.0, 25.0)
        return depth_cam  # meters; 0 = invalid/sky

    def __getitem__(self, idx: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng(self.seed * 100003 + idx)
        H, W, g = self.h, self.w, self.grid
        hs, ws = H // self.ds, W // self.ds

        depth_m = self._scene_depth(rng, H, W, self.K)
        rgb = rng.uniform(0, 1, (H, W, 3)).astype(np.float32) * 0.3
        rgb += (depth_m[..., None] / 25.0) * 0.7  # depth-correlated shading
        sparse = depth_m * (rng.uniform(size=depth_m.shape) < 0.3)
        rgbd = np.concatenate(
            [rgb, (sparse[..., None] * 1000.0)], axis=-1
        ).astype(np.float32)

        depth_label = (depth_m * 1000.0).astype(np.float32)  # mm, 0 invalid

        fimg = rng.normal(size=(hs, ws, self.fdn)).astype(np.float32) * 0.1
        fimg += depth_m[:: self.ds, :: self.ds, None][:hs, :ws] / 25.0

        # BEV labels on the grid
        sam = rng.integers(0, self.sam_classes, size=(g // 8, g // 8))
        sam = np.kron(sam, np.ones((8, 8), dtype=np.int64))
        dyn_cls = rng.integers(0, self.dyn_classes, size=(g // 16, g // 16))
        dyn_cls = np.kron(dyn_cls, np.ones((16, 16), dtype=np.int64))
        dyn = np.stack(
            [rng.integers(0, 8, size=(g, g)), dyn_cls, (dyn_cls > 0)], axis=-1
        ).astype(np.float32)
        elev_min = rng.normal(scale=0.05, size=(g, g)).astype(np.float32)
        elev = np.stack([elev_min, elev_min + np.abs(
            rng.normal(scale=0.3, size=(g, g))
        ).astype(np.float32)], axis=-1)

        # expert trajectory: forward arc from the ego cell (g-1 is behind)
        t = np.linspace(0, 1, self.horizon)
        curve = rng.uniform(-30, 30)
        rows = g // 2 - t * (0.45 * g)
        cols = g // 2 + curve * t * t
        expert = np.tile(np.eye(3, dtype=np.float32), (self.horizon, 1, 1))
        yaw = np.arctan2(np.gradient(cols), -np.gradient(rows))
        expert[:, 0, 0] = np.cos(yaw)
        expert[:, 0, 1] = -np.sin(yaw)
        expert[:, 1, 0] = np.sin(yaw)
        expert[:, 1, 1] = np.cos(yaw)
        expert[:, 0, 2] = np.clip(rows, 0, g - 1)
        expert[:, 1, 2] = np.clip(cols, 0, g - 1)

        # movability: a deterministic dynamic-object blob in image space
        hs, ws = self.h // self.ds, self.w // self.ds
        mv_mask = np.ones((hs, ws), bool)
        mv_mask[hs // 3: hs // 2, ws // 3: ws // 2] = False

        # counterfactuals: perturbed copies, first is rank 0
        n_valid = int(rng.integers(2, self.n_cf + 1))
        cf_traj = np.zeros((self.n_cf, self.horizon, 2), np.float32)
        cf_rank = np.zeros((self.n_cf,), np.int32)
        cf_valid = np.zeros((self.n_cf,), bool)
        base = np.stack([expert[:, 0, 2], expert[:, 1, 2]], axis=-1)
        for n in range(n_valid):
            jitter = rng.normal(scale=6.0 * (n > 0), size=(2,))
            cf_traj[n] = np.clip(base + jitter, 0, g - 1)
            cf_rank[n] = 0 if n == 0 else n
            cf_valid[n] = True

        return {
            "image": rgbd[None],  # [V=1, H, W, 4]
            "depth_label": depth_label[None],  # [S=1, H, W]
            "fimg_label": fimg[None],  # [V=1, hs, ws, D]
            "p2p": self.p2p()[None],  # [V=1, 4, 4]
            "fov_mask": self.fov_mask.copy(),  # [g, g] bool
            "mv_mask": mv_mask[None],  # [V=1, hs, ws] bool (static pixels)
            "3d_sam_label": sam.astype(np.int32),  # [g, g]
            "3d_sam_dynamic_label": dyn,  # [g, g, 3]
            "elevation_label": elev,  # [g, g, 2]
            "traversability_label": expert,  # [T, 3, 3]
            "counterfactuals_label": {
                "trajectories": cf_traj,
                "rank": cf_rank,
                "valid": cf_valid,
            },
        }


def collate(samples: list[dict]) -> dict:
    """Stack a list of sample dicts into a batch (nested dicts supported)."""
    out = {}
    for k in samples[0]:
        if isinstance(samples[0][k], dict):
            out[k] = collate([s[k] for s in samples])
        else:
            out[k] = np.stack([s[k] for s in samples])
    return out

