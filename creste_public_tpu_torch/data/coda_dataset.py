"""UT CODa on-disk dataset reader.

A copy of ``creste_public_tpu/data/coda_dataset.py``: the same samples,
bit for bit, from the same directory tree. Its differences: on the CPU
(``device="cpu"``) frames are decoded by the port's PIL-backed
``native_io`` (the JAX reader's PIL branch); on a card (the default) the
RGBD ``image`` is decoded by nvJPEG and assembled and resized by the
kernel of ``ops/frame_kernel.py`` (``native_io.DeviceFrameDecoder``),
equal to the PIL path's from the same pixels, its RGB within JPEG
decoders' rounding of PIL's; the calibration files are read without YAML
(``calib.read_calibration_yaml``), the per-sequence calibration and pose
caches are instance dicts (the dataset pickles into the process-mode
loader's workers), and the two helpers it takes from the JAX package's
preprocessing modules are private copies here.

Parity target: CodaPEFreeDataset (creste/datasets/codapefree_dataloader.py:32,
__getitem__:459-523) — produces the same per-sample tensor dict as
data/synthetic.py (the framework-wide contract), read from the CODa layout
(README.md:78-108):

  image                [V, H, W, 4]  RGB/255 + depth-mm channel
  depth_label          [S, H, W]     dense depth mm (0 = invalid)
  fimg_label           [V, hs, ws, D] DINOv2 distillation features
  p2p                  [V, 4, 4]     pixel->LiDAR at feature ds
  fov_mask             [g, g]        trapezoidal camera FOV on the BEV grid
  3d_sam_label         [g, g]        static SAM instance ids (uint16 npy)
  3d_sam_dynamic_label [g, g, 3]     (instance, class, occupancy)
  elevation_label      [g, g, 2]     (min, max) elevation bins
  traversability_label [T, 3, 3]     expert SE(2) chain on the BEV grid
  counterfactuals_label {trajectories [N,T,2], rank [N], valid [N]}

Host design: every key but ``image`` is read with NumPy/PIL on the host,
and the sample stays numpy on either device (augmentation, collate and
the loader's workers stay on the host); ragged counterfactual pickles are padded
to static [N_max, T, 2] with validity masks (replacing the reference's
python-list collate, codapefree_dataloader.py:251-275).
"""
from __future__ import annotations

import os
import pickle
import threading
import warnings
from typing import Any

import numpy as np
import torch
from PIL import Image

from creste_public_tpu_torch.data import coda_constants as cc
from creste_public_tpu_torch.data import native_io
from creste_public_tpu_torch.data import taxonomy as T
from creste_public_tpu_torch.data.calib import (
    Calibration,
    load_calibration,
    load_poses,
)
from creste_public_tpu_torch.ops.frame_kernel import cuda_device
from creste_public_tpu_torch.utils import geometry as geo
from creste_public_tpu_torch.utils.device import resolve_device

_DECODER_LOCK = threading.Lock()


def read_split(root: str, split: str) -> list[tuple[str, int]]:
    """splits/{split}.txt rows of '<seq> <frame>'."""
    path = os.path.join(root, cc.SPLITS_DIR, f"{split}.txt")
    out = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                out.append((parts[0], int(parts[1])))
    return out


def balanced_infos_resampling(
    samples: list, distances: np.ndarray, num_bins: int = 20, rng=None
) -> tuple[list, np.ndarray]:
    """Distance-balanced OVERsampling — reference-exact semantics
    (train_utils.py:836-905, called with num_bins=20 at
    codapefree_dataloader.py:297-299; pinned by the reference-exec golden):

    * every original sample is kept, grouped by bin in bin-index order;
    * bins under the uniform 1/num_bins share draw
      ``int(len * (1/num_bins / (frac + 1e-3) - 1))`` extra samples, with
      replacement only when the extra count exceeds the bin size;
    * bin edges are ``linspace(min, max, num_bins)`` with right-closed
      digitize — so the first bin holds only exact-minimum values
      (reference quirk, carried).

    ``rng``: anything with ``.choice`` (the reference draws from the global
    ``np.random`` state); defaults to a seeded RandomState for
    reproducibility.
    """
    distances = np.asarray(distances, float)
    n = len(samples)
    if rng is None:
        rng = np.random.RandomState(0)
    bins = np.linspace(distances.min(), distances.max(), num_bins)
    which = np.digitize(distances, bins, right=True) + 1
    out_idx: list[int] = []
    for b in range(1, num_bins + 1):
        idx = np.nonzero(which == b)[0]
        k = len(idx)
        if k == 0:
            continue
        frac = k / n
        ratio = (1.0 / num_bins) / (frac + 1e-3)
        extra = int(k * (ratio - 1.0))
        out_idx.extend(idx.tolist())
        if extra > 0:
            # index-based choice draws the same RNG sequence as the
            # reference's value-based np.random.choice
            picks = rng.choice(k, extra, replace=extra > k)
            out_idx.extend(int(idx[p]) for p in np.atleast_1d(picks))
    out_s = [samples[i] for i in out_idx]
    out_d = distances[np.asarray(out_idx, int)]
    return out_s, out_d


def filter_split(
    root: str, split: str, samples: list[tuple[str, int]],
    min_deviation: float = 0.0, resample: bool = False,
) -> list[tuple[str, int]]:
    """Apply the distance-based resampling + min-deviation filter when a
    `{split}_distances.txt` file exists (codapefree_dataloader.py:277-331)."""
    dist_path = os.path.join(root, cc.SPLITS_DIR, f"{split}_distances.txt")
    if not os.path.exists(dist_path):
        return samples
    distances = np.loadtxt(dist_path, dtype=float).reshape(-1)
    if len(distances) != len(samples):
        return samples
    if resample and split == "train":
        samples, distances = balanced_infos_resampling(samples, distances)
    keep = distances >= min_deviation
    return [s for s, k in zip(samples, keep) if k]


def median_filter_2d(x: np.ndarray, kernel: int) -> np.ndarray:
    """Zero-ignoring windowed median (train_utils.py:442-483): per window,
    the sorted-nonzero value at index nnz//2 (zeros pushed past the end);
    all-zero windows stay 0. Reflect padding, exact reference semantics
    (pinned by tests/test_reference_exec_preproc.py)."""
    H, W = x.shape
    p = kernel // 2
    xp = np.pad(x.astype(np.float64), p, mode="reflect")
    win = np.lib.stride_tricks.sliding_window_view(xp, (kernel, kernel))
    win = win.reshape(H, W, kernel * kernel).copy()
    win[win == 0] = np.inf
    win.sort(axis=-1)
    nnz = (win != np.inf).sum(-1)
    idx = np.clip(nnz // 2, 0, kernel * kernel - 1)
    out = np.take_along_axis(win, idx[..., None], -1)[..., 0]
    out[~np.isfinite(out)] = 0
    return out.astype(x.dtype)


def expand_filter_2d(x: np.ndarray, kernel: int) -> np.ndarray:
    """Max-pool dilation of non-zero label regions (train_utils.py:486-509),
    stride 1, same size."""
    H, W = x.shape
    p = kernel // 2
    xp = np.pad(x.astype(np.float64), p, mode="constant")
    win = np.lib.stride_tricks.sliding_window_view(xp, (kernel, kernel))
    return win.reshape(H, W, kernel * kernel).max(-1).astype(x.dtype)


def _make_labels_contiguous(label_map: np.ndarray,
                            ignore: int = 0) -> np.ndarray:
    """Compact label ids to 0..K (reference utils.make_labels_contiguous_
    vectorized); ignore stays 0. A copy of the JAX package's
    ``preprocessing/sam_map.py::make_labels_contiguous``, until the port
    has its preprocessing modules."""
    uniq = np.unique(label_map)
    uniq = uniq[uniq != ignore]
    out = np.zeros_like(label_map)
    for new, old in enumerate(uniq, start=1):
        out[label_map == old] = new
    return out


def _load_scan(root: str, seq: str, frame: int) -> np.ndarray:
    """Ouster .bin -> [N, 3] xyz (coda_utils OUSTER_CLOUD_DIM). A copy of
    the JAX package's ``preprocessing/depth.py::load_scan``, until the port
    has its preprocessing modules."""
    path = cc.frame_path(root, cc.POINTCLOUD_DIR, cc.DEFAULT_LIDAR, seq,
                         frame, "bin")
    raw = np.fromfile(path, np.float32)
    feats = cc.OUSTER_FEATURES if raw.size % cc.OUSTER_FEATURES == 0 else 5
    return raw.reshape(-1, feats)[:, :3]


def remap_contiguous(labels: np.ndarray, ignore: int = 0) -> np.ndarray:
    """Compact instance ids to 0..K keeping ``ignore`` fixed
    (codapefree_dataloader.py:627-648 behaviour)."""
    return _make_labels_contiguous(labels, ignore).astype(np.int32)


class CodaDataset:
    """Reads the CODa directory layout; one sample per (seq, frame).
    ``device`` decodes the frames' ``image``: a card (the default; raises
    without one) or ``"cpu"`` (PIL, bit-equal to the JAX reader)."""

    def __init__(self, cfg: Any, split: str = "train",
                 device: str | torch.device = "cuda"):
        device = resolve_device(device)
        self.device = (cuda_device(device) if device.type == "cuda"
                       else device)
        self._decoder = None  # made at first use
        self.root = cfg["root"]
        self.cam = cfg.get("cam", cc.DEFAULT_CAM)
        self.views = int(cfg.get("views", 1))
        self.ds = int(cfg.get("ds", 4))
        self.grid = int(cfg.get("grid", 256))
        self.map_range = float(cfg.get("map_range", 12.8))
        self.voxel = 2 * self.map_range / self.grid
        self.horizon = int(cfg.get("horizon", 50))
        self.traverse_step = int(cfg.get("traverse_step", 1))
        self.n_cf = int(cfg.get("n_counterfactuals", 6))
        self.depth_dir = cfg.get("depth_dir", "depth_5_LA_all")
        self.gt_depth_dir = cfg.get("gt_depth_dir", self.depth_dir)
        self.distill_dir = cfg.get("distill_dir", cc.DISTILLATION_LABEL_DIR)
        self.image_size = cfg.get("image_size", None)  # (H, W) or None
        self.infos = filter_split(
            self.root, split,
            read_split(self.root, cfg.get(f"{split}_split", split)),
            min_deviation=float(cfg.get("min_deviation", 0.0)),
            resample=bool(cfg.get("resample_trajectories", False)),
        )
        # FOV frustum from config; reference dataset defaults are
        # (70, 70, 7, 200) (codapefree_dataloader.py:179-184).
        top, bot, near, far = cfg.get("fov_angles", (70, 70, 7, 200))
        self.fov_horizon = int(cfg.get("fov_horizon", 1))
        # SAM label-cleanup kernels (reference task_cfgs kernel_size;
        # shipped configs: static 3, dynamic 5)
        self.sam_kernel_size = int(cfg.get("sam_kernel_size", 3))
        self.sam_dynamic_kernel_size = int(
            cfg.get("sam_dynamic_kernel_size", 5)
        )
        self.use_movability = bool(cfg.get("use_movability", False))
        self.mv_label_dir = cfg.get("mv_label_dir", "2d_sam_dynamic")
        self.load_point_cloud = bool(cfg.get("load_point_cloud", False))
        self.points_per_scan = int(
            cfg.get("points_per_scan", cc.OUSTER_POINTS)
        )
        fov = geo.create_trapezoidal_fov_mask(
            self.grid, self.grid, top, bot, near, far
        )
        self.fov_mask = fov
        self._calibs: dict[str, Calibration] = {}
        self._pose_chains: dict[str, np.ndarray] = {}

    def __len__(self) -> int:
        return len(self.infos)

    # -- per-sequence caches: instance dicts, which pickle with the dataset
    # and are per worker in process mode. Two loader threads may both miss
    # and load one sequence's file; each stores the same value. ----------
    def _calib(self, seq: str) -> Calibration:
        if seq not in self._calibs:
            self._calibs[seq] = load_calibration(self.root, seq, self.cam)
        return self._calibs[seq]

    def _poses(self, seq: str) -> np.ndarray:
        if seq not in self._pose_chains:
            self._pose_chains[seq] = load_poses(self.root, seq)
        return self._pose_chains[seq]

    # -- frame loaders -------------------------------------------------------
    def _image(self, seq: str, frame: int) -> np.ndarray:
        path = cc.frame_path(self.root, cc.CAMERA_DIR, self.cam, seq, frame, "jpg")
        return native_io.decode_jpeg(path).astype(np.float32) / 255.0

    def _depth_path(self, dirname: str, seq: str, frame: int) -> str:
        path = os.path.join(
            self.root, dirname, self.cam, str(seq), f"{frame}.png"
        )
        if not os.path.exists(path):
            path = cc.frame_path(
                self.root, dirname, self.cam, seq, frame, "png"
            )
        return path

    def _depth_png(self, dirname: str, seq: str, frame: int) -> np.ndarray:
        path = self._depth_path(dirname, seq, frame)
        return native_io.decode_png16(path).astype(np.float32)  # mm

    def _frame_decoder(self) -> native_io.DeviceFrameDecoder:
        with _DECODER_LOCK:
            if self._decoder is None:
                self._decoder = native_io.DeviceFrameDecoder(self.device)
            return self._decoder

    def _rgbd(self, seq: str, frame: int) -> tuple[np.ndarray, np.ndarray]:
        """(rgbd [h, w, 4] f32, its depth channel [h, w] f32) of a frame at
        cfg image_size: on a card decoded and assembled there, on the CPU
        by PIL."""
        if self.device.type == "cuda":
            rgbd = self._frame_decoder().assemble(
                cc.frame_path(self.root, cc.CAMERA_DIR, self.cam, seq, frame,
                              "jpg"),
                self._depth_path(self.depth_dir, seq, frame),
                None if self.image_size is None else tuple(self.image_size))
            return rgbd, rgbd[..., 3]
        rgb = self._image(seq, frame)
        depth = self._depth_png(self.depth_dir, seq, frame)
        rgb, depth = self._resized(rgb, depth)
        return np.concatenate([rgb, depth[..., None]], axis=-1), depth

    def _fimg(self, seq: str, frame: int) -> np.ndarray:
        path = os.path.join(
            self.root, self.distill_dir, self.cam, str(seq), f"{frame}.npy"
        )
        return np.load(path).astype(np.float32)  # [hs, ws, D] or [D, hs, ws]

    def _bev_npy(self, dirname: str, seq: str, frame: int) -> np.ndarray:
        path = os.path.join(self.root, dirname, str(seq), f"{frame}.npy")
        if not os.path.exists(path):
            path = os.path.join(
                self.root, dirname, str(seq),
                cc.frame_filename(dirname, "", seq, frame, "npy"),
            )
        return np.load(path)

    def _load_elevation(self, seq: str, frame: int) -> np.ndarray:
        """Reference on-disk contract first: raw f32 [grid, grid, 2] `.bin`
        (_load_elevation, codapefree_dataloader.py:617-625; build_feature_map
        save_elevation_to_file writes the flipped (min, max) channel stack);
        falls back to the repo's legacy gap-scan `.npy`."""
        path = os.path.join(
            self.root, cc.ELEVATION_LABEL_DIR, str(seq), f"{frame}.bin"
        )
        if os.path.exists(path):
            raw = np.fromfile(path, np.float32)
            return raw.reshape(self.grid, self.grid, 2)
        elev = self._bev_npy(cc.ELEVATION_LABEL_DIR, seq, frame)
        if elev.ndim == 3 and elev.shape[0] in (2, 3):
            elev = np.moveaxis(elev, 0, -1)
        return elev[..., :2].astype(np.float32)

    def _traversability(self, seq: str, frame: int) -> np.ndarray:
        """Pose chain -> SE(2) poses on the BEV grid
        (codapefree_dataloader.py:579-615)."""
        poses = self._poses(seq)
        T = self.horizon
        ids = np.clip(
            frame + np.arange(T) * self.traverse_step, 0, len(poses) - 1
        )
        chain = poses[ids]  # [T, 4, 4] world poses
        rel = np.linalg.inv(chain[0]) @ chain  # ego-relative
        out = np.stack([
            geo.se3_to_bev_se2(p, (self.grid, self.grid), self.voxel)
            for p in rel
        ]).astype(np.float32)
        out[:, :2, 2] = np.clip(out[:, :2, 2], 0, self.grid)
        return out

    def _counterfactuals(self, seq: str, frame: int) -> dict[str, np.ndarray]:
        path = os.path.join(
            self.root, cc.COUNTERFACTUAL_LABEL_DIR, str(seq), f"{frame}.pkl"
        )
        traj = np.zeros((self.n_cf, self.horizon, 2), np.float32)
        rank = np.zeros((self.n_cf,), np.int32)
        valid = np.zeros((self.n_cf,), bool)
        if os.path.exists(path):
            with open(path, "rb") as f:
                raw = pickle.load(f)
            trajs = raw.get("trajectories", [])
            ranks = raw.get("rank", list(range(len(trajs))))
            for i, (t, r) in enumerate(zip(trajs, ranks)):
                if i >= self.n_cf:
                    break
                t = np.asarray(t, np.float32)[: self.horizon]
                traj[i, : len(t)] = t[:, :2]
                if len(t) < self.horizon and len(t) > 0:
                    traj[i, len(t):] = t[-1, :2]
                rank[i] = int(r)
                valid[i] = True
        return {"trajectories": traj, "rank": rank, "valid": valid}

    # -- multiview support (PE-free distillation) ----------------------------
    def _se3_poses(self, seq: str) -> np.ndarray:
        # alias for readability; _poses already caches per sequence
        return self._poses(seq)

    def overlapping_frames(self, seq: str, frame: int, k: int,
                           seed: int = 0) -> list[int]:
        """k frames whose camera FOV overlaps the anchor's
        (create_pe_dataset.py overlap graph via geometry.get_overlapping_views)."""
        poses = self._se3_poses(seq)
        # restrict the search window for tractability
        lo = max(0, frame - 200)
        hi = min(len(poses), frame + 200)
        window = poses[lo:hi]
        cands = geo.get_overlapping_views(frame - lo, window) + lo
        # only frames whose image actually exists on disk
        cands = np.asarray([
            c for c in cands
            if os.path.exists(cc.frame_path(
                self.root, cc.CAMERA_DIR, self.cam, seq, int(c), "jpg"
            ))
        ], dtype=int)
        if len(cands) == 0:
            return [frame] * k
        rng = np.random.default_rng(seed)
        picks = rng.choice(cands, size=k, replace=len(cands) < k)
        return [int(p) for p in picks]

    def _resized(self, rgb: np.ndarray, depth: np.ndarray):
        """Resize an (rgb, depth) pair to cfg image_size (bilinear rgb,
        nearest depth; the reference's _load_rgbd resize semantics)."""
        if self.image_size is None or rgb.shape[:2] == tuple(self.image_size):
            return rgb, depth
        h, w = self.image_size
        rgb = np.asarray(
            Image.fromarray((rgb * 255).astype(np.uint8)).resize(
                (w, h), Image.BILINEAR
            ),
            np.float32,
        ) / 255.0
        depth = np.asarray(
            Image.fromarray(depth).resize((w, h), Image.NEAREST), np.float32
        )
        return rgb, depth

    def _p2p(self, seq: str) -> np.ndarray:
        """pixel->point at the LOADED resolution: when cfg image_size
        resizes the native frames, the intrinsics scale with them before
        the model-downsample ds (reference: ds_gt_depth spans resize AND
        model ds, codapefree_dataloader.py:803-816)."""
        calib = self._calib(seq)
        if (
            self.image_size is not None
            and calib.img_hw[0] > 0
            and tuple(self.image_size) != tuple(calib.img_hw)
        ):
            calib = calib.scaled(self.image_size[0] / calib.img_hw[0])
        return calib.pixel_to_point(ds=self.ds)

    def _view_sample(self, seq: str, frame: int, anchor_pose: np.ndarray):
        """(rgbd [H,W,4], p2p-into-anchor-frame [4,4]) for one view."""
        rgbd, _ = self._rgbd(seq, frame)
        p2p = self._p2p(seq)
        pose = self._se3_poses(seq)[frame]
        rel = np.linalg.inv(anchor_pose) @ pose  # anchor_from_view
        return rgbd.astype(np.float32), (rel @ p2p).astype(np.float32)

    # -- sample --------------------------------------------------------------
    def _frame_fov_mask(self, seq: str, frame: int) -> np.ndarray:
        """Pose-warped (optionally accumulated) frustum mask
        (codapefree_dataloader.py:691-709). With fov_horizon == 1 the chain
        is [identity] and this returns the static frustum — the reference's
        effective behaviour for frame-anchored samples."""
        if self.fov_horizon <= 1:
            return self.fov_mask.copy()
        poses = self._se3_poses(seq)
        ids = np.clip(np.arange(self.fov_horizon) + frame, 0, len(poses) - 1)
        rel = np.linalg.inv(poses[frame]) @ poses[ids]
        return geo.accumulated_fov_mask(self.fov_mask, rel, self.voxel)

    def _immovable_depth_mask(self, seq: str, frame: int) -> np.ndarray:
        """[H/ds, W/ds] bool — True where STATIC (immovable), from the
        dynamic per-pixel instance maps (codapefree_dataloader.py:739-764:
        `mask_np > 0` -> movable). Missing file -> all-static (the
        reference's default all-ones mask)."""
        path = os.path.join(
            self.root, self.mv_label_dir, self.cam, str(seq), f"{frame}.npy"
        )
        try:
            m = np.load(path)
        except FileNotFoundError:
            calib = self._calib(seq)
            h, w = self.image_size or calib.img_hw
            # ceil division: x[::ds] has ceil(len/ds) elements — must match
            # the strided branch for collation
            return np.ones((-(-h // self.ds), -(-w // self.ds)), bool)
        if m.ndim == 3:  # [H, W, 2] (instance, class) from video tracking
            m = m[..., 0]
        if self.image_size is not None and m.shape[:2] != tuple(self.image_size):
            h, w = self.image_size
            # int32 'I' mode: instance ids can exceed uint16 in long runs
            m = np.asarray(
                Image.fromarray(m.astype(np.int32), mode="I").resize(
                    (w, h), Image.NEAREST
                )
            )
        return (m == 0)[:: self.ds, :: self.ds]

    def __getitem__(self, idx: int) -> dict[str, np.ndarray]:
        seq, frame = self.infos[idx]
        if self.views > 1:
            return self._getitem_multiview(seq, frame, idx)
        rgbd, depth = self._rgbd(seq, frame)

        gt_depth = (
            depth
            if self.gt_depth_dir == self.depth_dir
            else self._depth_png(self.gt_depth_dir, seq, frame)
        )

        fimg = self._fimg(seq, frame)
        if fimg.ndim == 3 and fimg.shape[0] < fimg.shape[-1]:
            fimg = np.moveaxis(fimg, 0, -1)  # CHW -> HWC

        p2p = self._p2p(seq)

        sample = {
            "image": rgbd[None].astype(np.float32),
            "depth_label": gt_depth[None].astype(np.float32),
            "fimg_label": fimg[None],
            "p2p": p2p[None],
            "fov_mask": self._frame_fov_mask(seq, frame),
        }
        if self.use_movability:
            sample["mv_mask"] = self._immovable_depth_mask(seq, frame)[None]
        if getattr(self, "load_point_cloud", False):
            sample["point_cloud"] = self._load_point_cloud(seq, frame)
            sample["immovable_label"] = self._load_immovable_label(seq, frame)

        sam = self._try(lambda: self._bev_npy(cc.SAM_LABEL_DIR, seq, frame))
        if sam is not None:
            # reference _load_sam static path (codapefree_dataloader.py:
            # 640-643): zero-ignoring median filter THEN contiguous remap
            sample["3d_sam_label"] = remap_contiguous(
                median_filter_2d(
                    sam.astype(np.int32), self.sam_kernel_size
                )
            )
        dyn = self._try(
            lambda: self._bev_npy(cc.SAM_DYNAMIC_LABEL_DIR, seq, frame)
        )
        if dyn is not None:
            # dynamic path (codapefree_dataloader.py:644-646): per-channel
            # max-pool expansion of the (instance, class, occupancy) map
            dyn = dyn.astype(np.float32)
            k = self.sam_dynamic_kernel_size
            if k > 1:
                dyn = np.stack(
                    [expand_filter_2d(dyn[..., c], k)
                     for c in range(dyn.shape[-1])], axis=-1,
                ) if dyn.ndim == 3 else expand_filter_2d(dyn, k)
            sample["3d_sam_dynamic_label"] = dyn
        elev = self._try(lambda: self._load_elevation(seq, frame))
        if elev is not None:
            sample["elevation_label"] = elev
        ssc = self._try(lambda: self._load_count_bin(
            cc.SSC_LABEL_DIR, seq, frame, remap="sem"))
        if ssc is not None:
            sample["3d_ssc_label"] = ssc
        fsc = self._try(lambda: self._load_fsc(seq, frame))
        if fsc is not None:
            sample["3d_fsc_label"] = fsc
        soc = self._try(lambda: self._load_count_bin(
            cc.SOC_LABEL_DIR, seq, frame, remap="obj"))
        if soc is not None:
            sample["3d_soc_label"] = soc
        trav = self._try(lambda: self._traversability(seq, frame))
        if trav is not None:
            sample["traversability_label"] = trav
            sample["counterfactuals_label"] = self._counterfactuals(seq, frame)
        return sample

    def _load_count_bin(
        self, dirname: str, seq: str, frame: int, remap: str | None = None
    ) -> np.ndarray:
        """SSC/SOC per-voxel class-count bins -> [g, g, C_remap] float
        (codapefree_dataloader.py:656-690)."""
        path = os.path.join(self.root, dirname, str(seq), f"{frame}.bin")
        dtype = np.int64 if dirname == cc.SSC_LABEL_DIR else np.uint16
        raw = np.fromfile(path, dtype=dtype).astype(np.float32)
        C = raw.size // (self.grid * self.grid)
        t = raw.reshape(self.grid, self.grid, C)
        if remap == "sem":
            t = T.remap_and_sum_channels(t, T.SEM_REMAP)
        elif remap == "obj":
            t = T.remap_and_sum_channels(t, T.OBJ_REMAP)
        return t

    def _load_point_cloud(self, seq: str, frame: int) -> np.ndarray:
        """[P, 3] xyz padded/truncated to a static ``points_per_scan``
        (codapefree_dataloader.py:776-786; CODa scans are exactly
        POINTS_PER_SCAN — padding only matters for synthetic trees)."""
        pts = _load_scan(self.root, seq, frame)[:, :3].astype(np.float32)
        P = int(getattr(self, "points_per_scan", cc.OUSTER_POINTS))
        out = np.zeros((P, 3), np.float32)
        out[: min(P, len(pts))] = pts[:P]
        return out

    def _load_immovable_label(self, seq: str, frame: int) -> np.ndarray:
        """[P, 1] bool per-point immovability from 3d_comp_movability bins
        (codapefree_dataloader.py:766-774); missing file -> all static."""
        P = int(getattr(self, "points_per_scan", cc.OUSTER_POINTS))
        path = os.path.join(self.root, "3d_comp_movability", cc.DEFAULT_LIDAR,
                            str(seq), f"{frame}.bin")
        out = np.ones((P, 1), bool)
        try:
            m = np.fromfile(path, dtype=bool).reshape(-1, 1)
            out[: min(P, len(m))] = m[:P]
        except FileNotFoundError:
            pass
        return out

    def _load_fsc(self, seq: str, frame: int) -> np.ndarray:
        """FSC per-voxel GMP descriptor bins -> [g, g, F] float32
        (codapefree_dataloader.py:650-654)."""
        path = os.path.join(self.root, "3d_fsc", str(seq), f"{frame}.bin")
        raw = np.fromfile(path, np.float32)
        F = raw.size // (self.grid * self.grid)
        return raw.reshape(self.grid, self.grid, F)

    def _getitem_multiview(self, seq: str, frame: int, idx: int) -> dict:
        """Anchor + (views-1) FOV-overlapping views, p2p chained into the
        anchor LiDAR frame (the PE-free consistency contract,
        codapefree_dataloader.py:459-523 multiview path)."""
        anchor_pose = self._se3_poses(seq)[frame]
        frames = [frame] + self.overlapping_frames(
            seq, frame, self.views - 1, seed=idx
        )
        rgbds, p2ps, fimgs = [], [], []
        for f in frames:
            rgbd, p2p = self._view_sample(seq, f, anchor_pose)
            rgbds.append(rgbd)
            p2ps.append(p2p)
            fimgs.append(self._try(lambda f=f: self._fimg(seq, f)))
        sample = {
            "image": np.stack(rgbds),
            "p2p": np.stack(p2ps),
            "fov_mask": self._frame_fov_mask(seq, frame),
            "depth_label": np.stack(
                [self._depth_png(self.gt_depth_dir, seq, f) for f in frames]
            ).astype(np.float32),
        }
        if all(f is not None for f in fimgs):
            fs = [np.moveaxis(f, 0, -1) if f.ndim == 3 and f.shape[0] < f.shape[-1]
                  else f for f in fimgs]
            sample["fimg_label"] = np.stack(fs)
        elif any(f is not None for f in fimgs):
            # partial feature coverage would silently drop the distillation
            # task for this sample — surface it
            missing = [f for f, x in zip(frames, fimgs) if x is None]
            warnings.warn(
                f"fimg_label dropped for {seq}:{frame}: views {missing} have "
                f"no distillation features on disk", stacklevel=2,
            )
        return sample

    @staticmethod
    def _try(fn):
        try:
            return fn()
        except (FileNotFoundError, OSError):
            return None
