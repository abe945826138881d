"""Validation-time visual logging: BEV pred/GT composites.

A copy of ``creste_public_tpu/training/visual_log.py``: the same tags and
renders (``utils/visualization.py``), from an eval-mode forward of the
port's model on the model's device.

Parity target: the reference's validation image dumps to TensorBoard
(train_ssc.py:178-241 log_img_outputs, train_traversability.py:171-311):
per-task composites of predictions against labels rendered every
validation pass. Returns HWC uint8 images via utils.visualization; the
loop hands them to MetricLogger.log_image (TB) and writes PNGs under the
checkpoint dir.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from creste_public_tpu_torch.models.blocks.convnets import eval_form
from creste_public_tpu_torch.training import pipelines
from creste_public_tpu_torch.utils import visualization as vz


def render_stage_outputs(stage: str, outputs: dict, batch: dict,
                         index: int = 0) -> dict[str, np.ndarray]:
    """First-sample composites keyed by tag."""
    out: dict[str, np.ndarray] = {}

    def np0(key, source):
        v = source.get(key)
        return None if v is None else np.asarray(v[index])

    depth = np0("depth_preds_metric", outputs)
    if depth is not None:
        gt = np0("depth_label", batch)
        panels = [vz.colorize_depth(depth)]
        if gt is not None:
            g = gt[0] if gt.ndim == 3 else gt
            panels.append(vz.colorize_depth(g / 1000.0))
        out["depth/pred_vs_gt"] = vz.side_by_side(*panels)

    sam = np0("inpainting_sam_preds", outputs)
    if sam is not None:
        pred_ids = sam.argmax(-1)
        panels = [vz.visualize_bev_label(pred_ids, "instance")]
        gt = np0("3d_sam_label", batch)
        if gt is not None:
            panels.append(vz.visualize_bev_label(gt, "instance"))
        out["bev/sam_pred_vs_gt"] = vz.side_by_side(*panels)

    dyn = np0("inpainting_sam_dynamic_preds", outputs)
    if dyn is not None:
        panels = [vz.visualize_bev_label(dyn.argmax(-1), "semantic",
                                         num_classes=dyn.shape[-1])]
        gt = np0("3d_sam_dynamic_label", batch)
        if gt is not None:
            gid = gt[..., 1] if gt.ndim == 3 else gt
            panels.append(vz.visualize_bev_label(
                gid.astype(np.int64), "semantic", num_classes=dyn.shape[-1]))
        out["bev/dynamic_pred_vs_gt"] = vz.side_by_side(*panels)

    elev = np0("elevation_preds", outputs)
    if elev is not None:
        out["bev/elevation_pred"] = vz.visualize_bev_label(elev, "elevation")
        gt = np0("elevation_label", batch)
        # 3-D heightfield panel (reference visualize_elevation_3d_wrapper,
        # visualization.py:811) on the lower-elevation channel
        out["bev/elevation_3d"] = vz.visualize_elevation_3d(
            elev[..., 0], gt[..., 0] if gt is not None else None
        )

    reward = np0("traversability_preds", outputs)
    if reward is not None:
        img = vz.visualize_reward(reward[..., 0])
        expert = np0("traversability_label", batch)
        if expert is not None:
            # expert poses are on the full grid; reward is front-half ds2
            traj = expert[:, :2, 2] / 2.0
            img = vz.overlay_trajectory(img, traj)
        out["irl/reward_with_expert"] = img

    svf = np0("exp_svf", outputs)
    if svf is not None:
        out["irl/expected_svf"] = vz.colorize_scalar(svf, cmap="magma")

    policy = np0("policy", outputs)
    if policy is not None:
        out["irl/policy"] = vz.visualize_bev_policy(policy)
    return out


def _first(batch):
    """The batch's first sample, kept as a batch of one (nested dicts
    too)."""
    return {k: _first(v) if isinstance(v, dict) else v[:1]
            for k, v in batch.items()}


def _host(v: torch.Tensor) -> np.ndarray:
    v = v.detach()
    if v.is_floating_point() and v.dtype != torch.float64:
        v = v.float()
    return v.cpu().numpy()


def log_visuals(stage: str, model, batch: dict, logger, step: int,
                out_dir: str | None = None) -> dict[str, np.ndarray]:
    """Eval-mode forward of ``model`` on the first sample of the host
    ``batch``, on the model's device under ``torch.no_grad()`` (each
    submodule's mode restored after), the renders of
    ``render_stage_outputs``, each handed to ``logger.log_image`` and, with
    ``out_dir``, written there as ``{tag with / -> _}_{step}.png``.
    Returns the images by tag."""
    from creste_public_tpu_torch.training.loop import to_device

    device = next(model.parameters()).device
    inputs = to_device(_first(batch), device)
    with torch.no_grad(), eval_form(model):
        outputs = model(*pipelines.model_inputs(stage, inputs))
    outputs = {k: _host(v) for k, v in outputs.items()
               if isinstance(v, torch.Tensor)}
    images = render_stage_outputs(stage, outputs, batch)
    for tag, img in images.items():
        logger.log_image(tag, img, step)
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            vz.save_png(
                os.path.join(out_dir, f"{tag.replace('/', '_')}_{step}.png"),
                img,
            )
    return images
