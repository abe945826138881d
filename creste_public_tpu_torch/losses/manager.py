"""Config-driven loss registry (LossManager) with the stage-3 MaxEnt-IRL loss.

Counterpart of ``creste_public_tpu/losses/manager.py`` (``Loss``,
``MaxEntIRLLoss``, ``LossManager``). Losses read predictions, labels and
masks from the merged dict keyed ``inputs/...`` / ``outputs/...`` and return
``{name: (weight, value)}`` plus a metadata dict. All maps are NHWC. The
other losses of the JAX registry are not ported yet: asking for one raises
``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any

import torch

from creste_public_tpu_torch.ops.rasterize import rasterize_trajectory
from creste_public_tpu_torch.utils.imageops import resize_and_crop

# losses of the JAX package's registry that the port does not have yet
_NOT_PORTED = ("CrossEntropyDepth", "SmoothL1Depth", "SmoothL1", "MSELoss",
               "PEFreeMSELoss", "CrossEntropy", "FocalLoss", "SupPixelConLoss",
               "BCActionLoss", "TREXLoss", "BalancedContrastiveLoss",
               "VicregLoss")


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


_REGISTRY: dict[str, type[Loss]] = {"MaxEntIRLLoss": MaxEntIRLLoss}


def make_loss(config: Any) -> Loss:
    name = config["name"]
    if name in _NOT_PORTED:
        raise NotImplementedError(f"loss {name} is not ported yet")
    return _REGISTRY[name](config)


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
