"""Config-driven loss registry (LossManager) with the stage-2 losses and
the stage-3 losses.

Counterpart of ``creste_public_tpu/losses/manager.py``, its whole registry:
``Loss``, the depth, regression, distillation, BEV cross-entropy, focal and
contrastive losses of stages 0-2 (SAM-instance SupCon, the balanced
l_spread loss, VICReg between the anchor and the movability-masked BEV
features), the PE-free multiview consistency loss of stage 1, and
``MaxEntIRLLoss``, ``BCActionLoss`` and ``TREXLoss`` of stage 3, with
``LossManager``. Losses read predictions, labels and masks from the merged
dict keyed ``inputs/...`` / ``outputs/...`` and return ``{name: (weight,
value)}`` plus a metadata dict, under the JAX package's keys. All maps are
NHWC. A loss that samples at random takes its priorities from
``aux["rng"]`` (``supcon.priorities``).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from creste_public_tpu_torch.losses.balancedsupcon import (
    bal_contrastive_loss,
)
from creste_public_tpu_torch.losses.supcon import (
    PrioritySource,
    capped_class_sample,
    multi_pos_con_loss,
    priorities,
    remap_labels_per_batch,
)
from creste_public_tpu_torch.ops.rasterize import rasterize_trajectory
from creste_public_tpu_torch.ops.value_iteration import DYNAMICS
from creste_public_tpu_torch.utils import depth as du
from creste_public_tpu_torch.utils.imageops import (
    resize_and_crop,
    resize_nearest,
)

def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    m = mask.to(x.dtype)
    return (x * m).sum() / torch.clamp(m.sum(), min=1.0)


def smooth_l1(pred: torch.Tensor, target: torch.Tensor,
              beta: float) -> torch.Tensor:
    d = (pred - target).abs()
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)


def load_class_weights(path: str, epsilon_w: float = 1e-5) -> torch.Tensor:
    freq = np.loadtxt(path)
    return torch.from_numpy(
        (1.0 / np.log(freq + epsilon_w)).astype(np.float32))


def _gradient(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``jnp.gradient`` along ``dim`` at unit spacing: central differences
    inside, one-sided ones at the two edges."""
    n = x.shape[dim]
    inner = (x.narrow(dim, 2, n - 2) - x.narrow(dim, 0, n - 2)) * 0.5
    return torch.cat([x.narrow(dim, 1, 1) - x.narrow(dim, 0, 1), inner,
                      x.narrow(dim, n - 1, 1) - x.narrow(dim, n - 2, 1)],
                     dim=dim)


def _gt_mode(gt: torch.Tensor, class_dim: int,
             epsilon_w: float = 1e-5) -> torch.Tensor:
    """[B, H, W, C] label tensor -> [B, H, W] class ids."""
    if class_dim < 0:
        prob = gt / (gt.sum(-1, keepdim=True) + epsilon_w)
        return prob.argmax(-1)
    return gt[..., class_dim].long()


def _depth_bins(config: Any, pred: torch.Tensor, gt: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor, int]:
    """The [B, S, H, W] mm depth label as [B*S, h, w] at the prediction's
    size (nearest), its target bins and the bin count."""
    B, S, H, W = gt.shape
    gt = gt.reshape(B * S, H, W)
    if tuple(pred.shape[1:3]) != tuple(gt.shape[1:3]):
        gt = resize_nearest(gt, tuple(pred.shape[1:3]))
    disc = config["discretize"]
    nb = int(disc["num_bins"])
    gt_bin = du.bin_depths(gt, disc["mode"], float(disc["depth_min"]),
                           float(disc["depth_max"]), nb, target=True)
    return gt, gt_bin, nb


class Loss:
    """Base: applies the static weight and the optional learned
    log-variance weight (Kendall-style)."""

    def __init__(self, config: Any):
        self.config = config
        self.name = config["name"] + config.get("tag", "")
        self.weight = float(config.get("weight", 1.0))
        self.task = config.get("task", None)

    def __call__(self, td: dict, aux: dict | None = None):
        loss_dict, meta = self.loss(td, aux or {})
        out = {}
        logvar_key = self.config.get("logvar_key", None)
        if logvar_key is not None:
            log_var = td[logvar_key]
            w = 1.0 / (2.0 * torch.exp(log_var))
            out["log_std"] = (1.0, 0.5 * log_var.sum())
        else:
            w = 1.0
        out.update({k: (self.weight * w, v) for k, v in loss_dict.items()})
        return out, meta

    def loss(self, td: dict, aux: dict):
        raise NotImplementedError


class CrossEntropyDepth(Loss):
    """Depth as classification over bins (reference loss_utils.py:477-527)."""

    def loss(self, td, aux):
        pred = td[self.config["pred_key"]]  # [BS, H, W, D]
        _, gt_bin, nb = _depth_bins(self.config, pred,
                                    td[self.config["lab_key"]])
        valid = gt_bin != nb
        logq = F.log_softmax(pred, dim=-1)
        ce = -logq.gather(-1, torch.clamp(gt_bin, 0, nb - 1).long()
                          [..., None])[..., 0]
        loss = masked_mean(ce, valid)
        acc = masked_mean((pred.argmax(-1) == gt_bin).float(), valid)
        return {"depth/cls_loss": loss}, {"depth/acc": acc}


class SmoothL1Depth(Loss):
    """Metric-depth regression (reference loss_utils.py:530-573)."""

    def loss(self, td, aux):
        pred = td[self.config["pred_key"]]  # [BS, H, W] metres
        gt, gt_bin, nb = _depth_bins(self.config, pred,
                                     td[self.config["lab_key"]])
        loss = masked_mean(
            smooth_l1(pred, gt / 1000.0, float(self.config["beta"])),
            gt_bin != nb)
        return {"depth/reg_loss": loss}, {}


class SmoothL1(Loss):
    """SmoothL1 with the relative-channel mode: channel 1 of the label
    becomes channel 1 minus channel 0 (reference loss_utils.py:576-603)."""

    def loss(self, td, aux):
        pred = td[self.config["pred_key"]]  # [B, H, W, C]
        gt = td[self.config["lab_key"]]
        if not self.config.get("absolute", False):
            gt = torch.cat([gt[..., :1], gt[..., 1:2] - gt[..., :1],
                            gt[..., 2:]], dim=-1)
        if self.config.get("take_grad", False):
            pred = torch.cat([_gradient(pred, 1), _gradient(pred, 2)], -1)
            gt = torch.cat([_gradient(gt, 1), _gradient(gt, 2)], -1)
        valid = torch.isfinite(gt)
        gt_safe = torch.where(valid, gt, torch.zeros_like(gt))
        loss = masked_mean(
            smooth_l1(pred, gt_safe, float(self.config["beta"])), valid)
        return {"val": loss}, {}


def _bev_overlap_hits(anchor_xy: torch.Tensor, aug_xy: torch.Tensor,
                      threshold: float = 1.0, chunk: int = 4096
                      ) -> torch.Tensor:
    """For each aug-view pixel, whether ANY anchor pixel lies within L2
    ``threshold`` of its BEV coordinate (strictly, ``d2 < threshold**2``).

    A full cdist is [N, N*V] pairs per element, so the anchors go in chunks
    with a running any. The squared distance is ``dx*dx + dy*dy`` in f32, as
    the JAX package sums it: ``torch.cdist`` or the |a|^2 + |b|^2 - 2ab
    expansion round otherwise and flip points on the boundary.

    anchor_xy [B, N, 2], aug_xy [B, M, 2] -> [B, M] bool.
    """
    thr2 = threshold * threshold
    ax, ay = anchor_xy.float().unbind(-1)  # [B, N]
    qx, qy = (c[:, :, None] for c in aug_xy.float().unbind(-1))  # [B, M, 1]
    hits = torch.zeros(aug_xy.shape[:2], dtype=torch.bool,
                       device=aug_xy.device)
    for s in range(0, anchor_xy.shape[1], chunk):
        dx = qx - ax[:, None, s:s + chunk]
        dy = qy - ay[:, None, s:s + chunk]
        hits |= (dx * dx + dy * dy < thr2).any(-1)
    return hits


class MSELoss(Loss):
    """Dense feature-distillation MSE over the finite labels (reference
    loss_utils.py:606-647).

    ``overlap_only: true`` is the BEV-overlap variant (reference
    train_utils.py:355-440): the MSE on the anchor view plus, per batch
    element, the MSE over the aug-view pixels whose BEV coordinate
    (``coords_key``, the multiview splat's ``bev_coords``) lies within one
    voxel of any anchor pixel's, summed (not averaged) over the batch. An
    element with no overlapping pixel adds 0."""

    def loss(self, td, aux):
        pred = td[self.config["pred_key"]]
        gt = td[self.config["lab_key"]]
        if self.config.get("overlap_only", False):
            return {"loss": self._overlap_loss(td, pred, gt)}, {}
        valid = ~torch.isinf(gt)
        gt_safe = torch.where(valid, gt, torch.zeros_like(gt))
        return {"loss": masked_mean((pred - gt_safe) ** 2, valid)}, {}

    def _overlap_loss(self, td, pred, gt):
        coords = td[self.config.get("coords_key", "outputs/bev_coords")]
        B, V, H, W, Z = pred.shape
        fin_a = ~torch.isinf(gt[:, 0])
        anchor = masked_mean(
            (pred[:, 0] - torch.where(fin_a, gt[:, 0],
                                      torch.zeros_like(gt[:, 0]))) ** 2,
            fin_a)
        if V == 1:
            return anchor
        coords = coords.reshape(B, V, H * W, 2)
        hits = _bev_overlap_hits(
            coords[:, 0], coords[:, 1:].reshape(B, (V - 1) * H * W, 2))
        gt_aug = gt[:, 1:].reshape(B, -1, Z)
        fin = ~torch.isinf(gt_aug)
        diff2 = (pred[:, 1:].reshape(B, -1, Z)
                 - torch.where(fin, gt_aug, torch.zeros_like(gt_aug))
                 ) ** 2 * fin
        w = hits.to(pred.dtype)[..., None]
        per_b = (diff2 * w).sum((1, 2)) / torch.clamp(
            (w * fin).sum((1, 2)), min=1.0)
        return per_b.sum() + anchor


class PEFreeMSELoss(Loss):
    """Multiview consistency of the splatted PE-free features (reference
    loss_utils.py:650-734): the MSE between the anchor view's BEV features
    and each other view's, over the cells where the normalised log of the
    two densities' product exceeds ``density_threshold``."""

    def loss(self, td, aux):
        pred = td[self.config["pred_key"]]  # [B*V, H, W, Z]
        density = td[self.config["lab_key"]]  # [B*V, H, W, 1]
        V = int(self.config["num_views"]) + 1
        thr = float(self.config.get("density_threshold", 1e-3))
        BV, H, W, Z = pred.shape
        B = BV // V
        pred = pred.reshape(B, V, H, W, Z)
        density = density.reshape(B, V, H, W, 1)
        overlap = pred[:, 1:]
        anchor = pred[:, :1].expand_as(overlap)
        log_d = torch.log(density[:, :1] * density[:, 1:] + 1e-5)
        log_d = log_d - log_d.amin(1, keepdim=True)
        log_d = log_d / (log_d.amax(1, keepdim=True)
                         - log_d.amin(1, keepdim=True) + 1e-5)
        valid = (log_d > thr).detach()
        return {"loss": masked_mean((anchor - overlap) ** 2,
                                    valid.expand_as(overlap))}, {}


class CrossEntropy(Loss):
    """BEV semantic cross-entropy with optional class weights and the FOV
    mask (reference loss_utils.py:379-474)."""

    def __init__(self, config):
        super().__init__(config)
        self.class_weights = (load_class_weights(config["class_weights"])
                              if "class_weights" in config else None)

    def loss(self, td, aux):
        pred = td[self.config["pred_key"]]  # [B, H, W, C]
        gt = td[self.config["lab_key"]]  # [B, H, W, F]
        fov = td[self.config.get("mask_key", "inputs/fov_mask")]
        gt_mode = _gt_mode(gt, int(self.config.get("class_dim", -1)))
        C = pred.shape[-1]
        ignore = self.config.get("ignore_index", None)

        valid = fov.bool()
        if ignore is not None:
            valid = valid & (gt_mode != ignore)
        safe = torch.clamp(gt_mode, 0, C - 1)
        logq = F.log_softmax(pred, dim=-1)
        ce = -logq.gather(-1, safe[..., None])[..., 0]
        if self.class_weights is not None:
            w = self.class_weights.to(pred.device)[safe]
            loss = (ce * w * valid).sum() / torch.clamp(
                (w * valid).sum(), min=1e-6)
        else:
            loss = masked_mean(ce, valid)
        # class 0 is taken as ignore for the metric
        acc = masked_mean((pred.argmax(-1) == gt_mode).float(),
                          valid & (gt_mode != 0))
        task = self.config.get("task", "3d_ssc")
        return {f"{task}/cls_loss": loss}, {f"{task}/acc": acc}


class FocalLoss(Loss):
    """Focal loss over the BEV semantics with optional class weights and
    the FOV mask (reference loss_utils.py:289-377, kornia-style)."""

    def __init__(self, config):
        super().__init__(config)
        self.class_weights = (load_class_weights(config["class_weights"])
                              if "class_weights" in config else None)

    def loss(self, td, aux):
        pred = td[self.config["pred_key"]]  # [B, H, W, C]
        gt = td[self.config["lab_key"]]
        fov = td[self.config.get("mask_key", "inputs/fov_mask")]
        gt_mode = _gt_mode(gt, int(self.config.get("class_dim", -1)))
        C = pred.shape[-1]
        alpha = float(self.config.get("alpha", 0.25))
        gamma = float(self.config.get("gamma", 2.0))

        valid = fov.bool()
        safe = torch.clamp(gt_mode, 0, C - 1)
        logpt = F.log_softmax(pred, dim=-1).gather(-1, safe[..., None])[..., 0]
        fl = -alpha * (1.0 - torch.exp(logpt)) ** gamma * logpt
        if self.class_weights is not None:
            fl = fl * self.class_weights.to(pred.device)[safe]
        loss = masked_mean(fl, valid)

        ignore = self.config.get("ignore_index", None)
        acc_valid = valid if ignore is None else valid & (gt_mode != ignore)
        acc = masked_mean((pred.argmax(-1) == gt_mode).float(), acc_valid)
        task = self.config.get("task", "3d_ssc")
        return {f"{task}/cls_loss": loss}, {f"{task}/FocalLoss/acc": acc}


class SupPixelConLoss(Loss):
    """SAM-instance pixel contrastive loss on the anchor view (reference
    loss_utils.py:203-286). ``aux["rng"]`` is the sampling's priority
    source (``supcon.priorities``); under data parallelism ``aux["group"]``
    is the ranks' process group, whose features every rank's anchors are
    contrasted with."""

    def __init__(self, config):
        super().__init__(config)
        self.class_weights = (load_class_weights(config["class_weights"])
                              if "class_weights" in config else None)
        self.max_samples = int(config.get("max_samples", 2048))

    def loss(self, td, aux):
        preds = td[self.config["pred_key"]]  # [BV, H, W, Z]
        gt = td[self.config["lab_key"]]  # [B, H, W, C] or [B, H, W]
        fov = td[self.config.get("mask_key", "inputs/fov_mask")]
        views = int(self.config.get("views", 1))
        ignore = int(self.config.get("ignore_index", -1))
        temp = float(self.config.get("temperature", 0.1))

        if gt.dim() == 4 and gt.shape[-1] > 1:
            label = gt.argmax(-1)
        elif gt.dim() == 4:
            label = gt[..., 0]
        else:
            label = gt
        label = label.to(torch.int32)

        BV = preds.shape[0]
        B = BV // views
        H, W, Z = preds.shape[1:]
        preds0 = preds.reshape(B, views, H, W, Z)[:, 0]
        label0 = label.reshape(B, views, H, W)[:, 0]
        if fov.dim() == 3 and fov.shape[0] == BV:
            fov = fov.reshape(B, views, H, W)[:, 0]
        if self.config.get("lab_key", "").endswith("3d_sam_label"):
            label0 = remap_labels_per_batch(label0, ignore_idx=0)
        valid = (label0 != ignore) & fov.bool()

        flat_feats = preds0.reshape(-1, Z)
        flat_labels = label0.reshape(-1)
        idx, sel_valid = capped_class_sample(
            flat_labels, valid.reshape(-1), self.max_samples, cap=1000,
            rng=aux.get("rng", None))
        cw = (self.class_weights.to(preds.device)
              if self.class_weights is not None else None)
        loss = multi_pos_con_loss(flat_feats[idx], flat_labels[idx],
                                  sel_valid, temperature=temp,
                                  class_weights=cw,
                                  group=aux.get("group", None))
        task = self.config.get("task", "3d_ssc")
        key = self.config.get("lab_key", "x/x").split("/")[-1]
        return {f"{task}/{key}/supcon/sem_loss": loss,
                f"{task}/{key}/supcon/img_loss": loss}, {}


class MaxEntIRLLoss(Loss):
    """MaxEnt IRL objective with counterfactual mixing and a WGAN-style
    penalty on the reward's gradient (reference loss_utils.py:971-1259).

    ``aux["reward_fn"]`` maps an NHWC input view to the reward [B, H, W, 1];
    the penalty differentiates it with ``torch.autograd.grad(...,
    create_graph=True)`` so that the penalty's own gradient reaches the
    reward head's parameters."""

    def loss(self, td, aux):
        exp_svf = td[self.config["pred_key"]]  # [B, H, W] policy SVF
        gt = td[self.config["lab_key"]]  # [B, T, 3, 3] expert SE(2)
        fov = td[self.config["fov_key"]]  # [B, Ho, Wo]
        reward = td["outputs/traversability_preds"][..., 0]  # [B, H, W]
        input_view = td["outputs/input_view"]

        map_ds = float(self.config.get("map_ds", 2))
        H, W = self.config.get("map_sz", [64, 128])
        maxent_w = float(self.config.get("maxent_weight", 1.0))
        reward_w = float(self.config.get("reward_weight", 0.1))
        use_fov = bool(self.config.get("use_fov_mask", False))
        alpha = self.config.get("alpha", None)

        B, Ho, Wo = fov.shape
        # nearest resize to half resolution, crop the front [0:H, 0:W]
        fov_r = resize_and_crop(fov.float(), (Ho // 2, Wo // 2),
                                (0, H, 0, W)).bool()

        svf = rasterize_trajectory(gt[:, :, :2, 2], map_ds, (H, W))
        if use_fov:
            svf = svf * fov_r
            exp_svf = exp_svf * fov_r
        svf = svf / (svf.sum((1, 2), keepdim=True) + 1e-5)
        exp_svf = exp_svf / (exp_svf.sum((1, 2), keepdim=True) + 1e-5)

        cf_svf_total = torch.zeros_like(svf)
        exp_svf_total = exp_svf
        cf_key = self.config.get("cf_key", None)
        cf = td.get(cf_key) if cf_key is not None else None
        if alpha is not None and cf is not None:
            traj = cf["trajectories"]  # [B, N, T, 2]
            Bc, Nc, Tc, _ = traj.shape
            bad = (cf["rank"] > 0) & cf["valid"].bool()  # [B, N]
            per_traj = rasterize_trajectory(
                traj.reshape(Bc * Nc, Tc, 2), map_ds, (H, W)
            ).reshape(Bc, Nc, H, W)
            cf_svf = (per_traj * bad[..., None, None]).sum(1)
            cf_svf = cf_svf / (cf_svf.sum((1, 2), keepdim=True) + 1e-5)
            has_cf = bad.any(dim=1)[:, None, None]
            exp_svf = torch.where(has_cf,
                                  alpha * cf_svf + (1 - alpha) * exp_svf,
                                  exp_svf)
            cf_svf_total = torch.where(has_cf, cf_svf, cf_svf_total)

        if use_fov:
            reward = reward * fov_r.to(reward.dtype)

        svf_rewards = (svf * reward).sum((1, 2))
        exp_rewards = (exp_svf * reward).sum((1, 2))
        visitation_loss = exp_rewards.mean() - svf_rewards.mean()

        reward_penalty = torch.zeros((), device=reward.device)
        reward_fn = aux.get("reward_fn", None)
        if reward_fn is not None and reward_w > 0:
            # the reward is masked BEFORE the gradient (reference
            # loss_utils.py:1193-1216): outside the FOV the penalty sees a
            # zero gradient and a (0 - 1)^2 term
            iv = input_view.detach().requires_grad_(True)
            r = reward_fn(iv)[..., 0]
            if use_fov:
                r = r * fov_r.to(r.dtype)
            (grad_iv,) = torch.autograd.grad(r.sum(), iv, create_graph=True)
            # eps-safe channel norm: d|x|/dx is NaN at x = 0, which a dead
            # relu gives, and would poison the second-order backward
            gn = torch.sqrt((grad_iv * grad_iv).sum(-1) + 1e-12)
            reward_penalty = ((gn - 1.0) ** 2).mean()

        loss = maxent_w * visitation_loss + reward_w * reward_penalty

        cf_rewards = (cf_svf_total * reward).detach().sum((1, 2))
        opt_rewards = (exp_svf_total * reward).detach().sum((1, 2))
        has = cf_rewards != 0
        meta = {
            "reward_penalty": reward_w * reward_penalty,
            "mean_expected_svf_rewards": exp_rewards.mean(),
            "mean_svf_rewards": svf_rewards.mean(),
            "sum_cf_rewards": (cf_rewards * has).sum(),
            "sum_opt_rewards": (opt_rewards * has).sum(),
        }
        return {"maxentirl_loss": loss}, meta


class BCActionLoss(Loss):
    """Binary cross-entropy of the action predictions against the one-hot
    of the action nearest each expert step (reference
    loss_utils.py:1261-1301); a tie goes to the first action, as
    ``argmin`` gives on both sides."""

    def loss(self, td, aux):
        pred = td[self.config["pred_key"]]  # [B, T, 8]
        gt = td[self.config["lab_key"]]  # [B, T, 3, 3]
        actions = torch.as_tensor(DYNAMICS, dtype=torch.float32,
                                  device=pred.device)
        deltas = gt[:, 1:, :2, 2] - gt[:, :-1, :2, 2]  # [B, T-1, 2]
        diff = actions[None, None] - deltas[:, :, None, :]
        dist = torch.sqrt((diff * diff).sum(-1))
        closest = F.one_hot(dist.argmin(-1), 8).to(pred.dtype)
        p = torch.clamp(pred[:, 1:], 1e-7, 1 - 1e-7)
        bce = -(closest * torch.log(p) + (1 - closest) * torch.log(1 - p))
        return {"bc_action_loss": bce.mean((0, 2)).sum() / pred.shape[1]}, {}


class TREXLoss(Loss):
    """Pairwise preference (T-REX) loss over the counterfactuals' rank
    pairs (reference loss_utils.py:1303-1404) on padded arrays: each
    trajectory's summed reward; the preferred (rank 0) and the other valid
    ones packed to the front in their order by a stable argsort; the pairs
    enumerated as the reference does, ``(pref[k % P], not_pref[k % Q])``
    for k < P*Q; the softmax over the valid pairs (-1e9 standing in for a
    non-finite entry) and the sum-BCE against all-ones labels, over the
    pair count plus ``l1_reg`` times the mean |reward|."""

    def loss(self, td, aux):
        pred = td[self.config["pred_key"]][..., 0]  # [B, H, W]
        cf = td[self.config["lab_key"]]
        map_ds = float(self.config.get("map_ds", 2))
        H, W = self.config.get("map_sz", [64, 128])
        l1_reg = float(self.config.get("l1_reg", 0.1))

        traj = torch.round(cf["trajectories"] / map_ds).to(torch.int64)
        rows = torch.clamp(traj[..., 0], 0, H - 1)
        cols = torch.clamp(traj[..., 1], 0, W - 1)  # [B, N, T]
        valid = cf["valid"].bool()  # [B, N]
        rank = cf["rank"]
        B, N = valid.shape
        dev = pred.device
        bidx = torch.arange(B, device=dev)[:, None, None]
        rew = pred[bidx, rows, cols].sum(-1)  # [B, N]

        pref = valid & (rank == 0)
        not_pref = valid & (rank > 0)
        r_pref_packed = rew.gather(1, torch.argsort(
            (~pref).to(torch.uint8), dim=1, stable=True))
        r_not_packed = rew.gather(1, torch.argsort(
            (~not_pref).to(torch.uint8), dim=1, stable=True))
        P, Q = pref.sum(1), not_pref.sum(1)  # [B]
        k = torch.arange(N * N, device=dev)[None, :]
        i = k % torch.clamp(P, min=1)[:, None]
        j = k % torch.clamp(Q, min=1)[:, None]
        r_pref = r_pref_packed.gather(1, i)
        r_not = r_not_packed.gather(1, j)
        pair_valid = k < (P * Q)[:, None]
        z = torch.logaddexp(r_pref, r_not)
        a, b = r_pref - z, r_not - z
        p1 = a / (a + b + 1e-6)
        flat = torch.where(pair_valid, p1, torch.full_like(p1, -torch.inf))
        sm = torch.softmax(torch.where(torch.isfinite(flat), flat,
                                       torch.full_like(flat, -1e9)), dim=-1)
        sm = torch.where(pair_valid, torch.clamp(sm, 1e-7, 1.0),
                         torch.ones_like(sm))
        bce = -torch.log(sm) * pair_valid
        n_pairs = torch.clamp(pair_valid.sum(), min=1)
        loss = bce.sum() / (n_pairs + l1_reg * pred.abs().mean())
        return {"trex_loss": loss}, {}


class BalancedContrastiveLoss(Loss):
    """The balanced l_spread contrastive loss over sampled BEV pixels of
    the anchor view (reference loss_utils.py:94-200 ->
    ``balancedsupcon.bal_contrastive_loss``), each view's feature of a
    sampled pixel unit-normalised. ``aux["rng"]`` is the sampling's
    priority source."""

    def loss(self, td, aux):
        preds = td[self.config["pred_key"]]  # [BV, H, W, Z]
        gt = td[self.config["lab_key"]]
        fov = td[self.config.get("mask_key", "inputs/fov_mask")]
        views = int(self.config.get("views", 1))
        max_samples = int(self.config.get("max_samples", 1024))
        ignore = int(self.config.get("ignore_index", 0))

        if gt.dim() == 4 and gt.shape[-1] > 1:
            label = _gt_mode(gt, -1)
        elif gt.dim() == 4:
            label = gt[..., 0]
        else:
            label = gt
        label = label.to(torch.int32)
        BV = preds.shape[0]
        B = BV // views
        H, W, Z = preds.shape[1:]
        preds = preds.reshape(B, views, H, W, Z)
        # each element's anchor view (b-major layout)
        label0 = (label if label.shape[0] == B
                  else label.reshape(B, views, H, W)[:, 0])
        fov0 = fov if fov.shape[0] == B else fov.reshape(B, views, H, W)[:, 0]
        valid = (label0 != ignore) & fov0.bool()

        idx, sel_valid = capped_class_sample(
            label0.reshape(-1), valid.reshape(-1), max_samples,
            cap=int(self.config.get("cap", 1000)), rng=aux.get("rng", None))
        feats = preds.permute(0, 2, 3, 1, 4).reshape(-1, views, Z)[idx]
        feats = feats * torch.rsqrt((feats * feats).sum(-1, keepdim=True)
                                    + 1e-12)
        loss = bal_contrastive_loss(
            feats, label0.reshape(-1)[idx],
            temperature=float(self.config.get("temperature", 0.5)),
            a_lc=float(self.config.get("a_lc", 1.0)),
            a_spread=float(self.config.get("a_spread", 1.0)),
            loss_type=self.config.get("type", "l_spread"), valid=sel_valid)
        return {"balcon_loss": loss}, {}


def vicreg_priorities(source, B: int, n: int, device: torch.device
                      ) -> tuple[list[PrioritySource], PrioritySource]:
    """VICReg's sampling priorities: one source per batch element for the
    pairwise term and one for the variance term. ``source`` is None (no
    randomness: the deterministic selection), a ``torch.Generator`` (B
    draws of ``n`` values, then one of ``B * n``), or the fed pair
    ``(pairs [B, n], variance [B * n])``."""
    if source is None or isinstance(source, torch.Generator):
        pairs = [priorities(source, n, device) for _ in range(B)]
        return pairs, priorities(source, B * n, device)
    if not isinstance(source, (tuple, list)) or len(source) != 2:
        raise ValueError("VicregLoss's priorities are a torch.Generator or "
                         "the pair (pairs [B, H*W], variance [B*H*W]); give "
                         "them as aux['vicreg_rng'] beside another loss's "
                         "fed aux['rng']")
    pairs, var = source
    if tuple(pairs.shape) != (B, n):
        raise ValueError(f"VICReg pair priorities of shape "
                         f"{tuple(pairs.shape)}, expected ({B}, {n})")
    return list(pairs), var


class VicregLoss(Loss):
    """VICReg between the anchor BEV features and the movability-masked
    multiview ones (``pred_mv_key``), with the reference's semantics
    (loss_utils.py:737-969):

      * invariance: the squared distance between anchor[i] and
        multiview[j] over every same-label pair of sampled pixels, per
        batch element, summed and divided once by the global pair count;
      * variance: the hinge relu(1 - sqrt(var + 1e-4)) of the unbiased
        variance over a per-label sample (cap ``max_variance_samples``)
        across the batch, for each view, summed;
      * covariance: the off-diagonal squares of the masked set's
        covariance (divisor N - 1) over Z, for each view, summed.

    The per-label samples are the capped sampler's static budgets
    (``sample_budget`` per element, ``variance_budget`` for the batch).
    Its priorities come from ``aux["vicreg_rng"]`` or else ``aux["rng"]``
    (see ``vicreg_priorities``)."""

    def loss(self, td, aux):
        anchor = td[self.config["pred_key"]]  # [B, H, W, Z]
        mv = td[self.config["pred_mv_key"]]
        fov = td[self.config.get("fov_key", "inputs/fov_mask")]
        gt = td[self.config["lab_key"]]
        sim_c = float(self.config.get("sim_coeff", 1.0))
        std_c = float(self.config.get("std_coeff", 1.0))
        cov_c = float(self.config.get("cov_coeff", 1.0))
        ignore = int(self.config.get("ignore_index", 0))
        pair_budget = int(self.config.get("sample_budget", 1024))
        var_budget = int(self.config.get("variance_budget", 512))
        pair_cap = int(self.config.get("max_samples_per_label", 2000))
        var_cap = int(self.config.get("max_variance_samples", 1))

        B, H, W, Z = anchor.shape
        if gt.dim() == 4 and gt.shape[-1] == 1:
            gt = gt[..., 0]
        if self.config["lab_key"].endswith("3d_ssc_label") and gt.dim() == 4:
            label = _gt_mode(gt, -1)  # class ids shared across the batch
            joint_label = label
        else:
            label = gt.to(torch.int32)
            # instances distinct across batch elements
            joint_label = remap_labels_per_batch(label, ignore_idx=ignore)
        label = label.to(torch.int32)

        mask = fov
        if tuple(mask.shape[-2:]) != (H, W):
            mask = resize_nearest(mask.float(), (H, W))
        valid = mask.bool() & (label != ignore)
        pair_pri, var_pri = vicreg_priorities(
            aux.get("vicreg_rng", aux.get("rng", None)), B, H * W,
            anchor.device)

        # invariance: same-label pairwise squared distances per element,
        # |a_i|^2 + |m_j|^2 - 2 a_i.m_j without the [S, S, Z] tensor
        a_flat = anchor.reshape(B, H * W, Z)
        m_flat = mv.reshape(B, H * W, Z)
        l_flat = label.reshape(B, H * W)
        v_flat = valid.reshape(B, H * W)
        totals, counts = [], []
        for b in range(B):
            idx, sel = capped_class_sample(l_flat[b], v_flat[b], pair_budget,
                                           cap=pair_cap, rng=pair_pri[b],
                                           use_median=False)
            A, M, li = a_flat[b][idx], m_flat[b][idx], l_flat[b][idx]
            eqf = ((li[:, None] == li[None, :]) & sel[:, None]
                   & sel[None, :]).to(anchor.dtype)
            pair = ((A * A).sum(-1)[:, None] + (M * M).sum(-1)[None, :]
                    - 2.0 * (A @ M.T))
            totals.append((pair * eqf).sum())
            counts.append(eqf.sum())
        sim = torch.stack(totals).sum() / torch.clamp(
            torch.stack(counts).sum(), min=1.0)

        # variance: a per-label sample across the batch
        vidx, vsel = capped_class_sample(
            joint_label.reshape(-1), valid.reshape(-1), var_budget,
            cap=var_cap, rng=var_pri, use_median=False)

        def std_hinge(x):
            s = x.reshape(-1, Z)[vidx]
            w = vsel.to(x.dtype)[:, None]
            n = w.sum()
            mean = (s * w).sum(0) / torch.clamp(n, min=1.0)
            var = ((s - mean) ** 2 * w).sum(0) / torch.clamp(n - 1, min=1.0)
            hinge = torch.clamp(1.0 - torch.sqrt(var + 1e-4), min=0.0).mean()
            return torch.where(n > 1, hinge, torch.zeros_like(hinge))

        std = std_hinge(anchor) + std_hinge(mv)

        # covariance: the whole masked set, both views
        wcol = valid.reshape(B * H * W, 1).to(anchor.dtype)
        n_all = torch.clamp(wcol.sum(), min=1.0)

        def cov_term(x):
            xm = x.reshape(B * H * W, Z)
            xc = (xm - (xm * wcol).sum(0) / n_all) * wcol
            cov = (xc.T @ xc) / torch.clamp(n_all - 1, min=1.0)
            off = cov - torch.diag(torch.diag(cov))
            return (off ** 2).sum() / Z

        cov = cov_term(anchor) + cov_term(mv)

        loss = sim_c * sim + std_c * std + cov_c * cov
        return {"vicreg_loss": loss}, {"vicreg/sim": sim_c * sim,
                                       "vicreg/std": std_c * std,
                                       "vicreg/cov": cov_c * cov}


_REGISTRY: dict[str, type[Loss]] = {
    cls.__name__: cls for cls in (
        CrossEntropyDepth, SmoothL1Depth, SmoothL1, MSELoss, PEFreeMSELoss,
        CrossEntropy, FocalLoss, SupPixelConLoss, MaxEntIRLLoss,
        BCActionLoss, TREXLoss, BalancedContrastiveLoss, VicregLoss)}


def make_loss(config: Any) -> Loss:
    return _REGISTRY[config["name"]](config)


class LossManager:
    """Dispatches the configured losses over the merged tensor dict."""

    def __init__(self, config: Any):
        self.losses = [make_loss(lc) for lc in config["loss"]]

    def __call__(self, tensor_dict: dict, aux: dict | None = None
                 ) -> tuple[dict, dict]:
        loss_dict, meta = {}, {}
        task = tensor_dict.get("task", None)
        for loss in self.losses:
            if loss.task is None or loss.task == task:
                ld, md = loss(tensor_dict, aux)
                loss_dict.update({f"{loss.name}/{k}": v for k, v in ld.items()})
                meta.update({f"{loss.name}/{k}": v for k, v in md.items()})
        return loss_dict, meta

    @staticmethod
    def total(loss_dict: dict) -> torch.Tensor:
        return sum(w * v for w, v in loss_dict.values())
