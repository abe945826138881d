"""Stage pipelines: model + LossManager + optimizer -> training step.

Counterpart of ``creste_public_tpu/training/pipelines.py``: the positional
model arguments of a stage, the merged tensor dict that the losses read
(``inputs/<batch key>``, ``outputs/<model key>``, ``task``), the loss
closure with the IRL penalty's ``reward_fn`` hook, ``init_stage`` and
``make_train_step``. Only stage 3 (``traversability``) is ported; the other
stages raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from creste_public_tpu_torch import weights
from creste_public_tpu_torch.losses.manager import LossManager
from creste_public_tpu_torch.models.blocks.effnet import DropConnect
from creste_public_tpu_torch.models.lfd import MaxEntIRL
from creste_public_tpu_torch.training import optim
from creste_public_tpu_torch.training.state import (
    LossClosure,
    TrainState,
    train_step,
)
from creste_public_tpu_torch.utils.device import resolve_device

STAGES = ("depth", "distillation", "ssc", "traversability")


def build_model(stage: str, cfg: Any) -> MaxEntIRL:
    cfg = cfg.to_dict() if hasattr(cfg, "to_dict") else cfg
    if stage == "traversability":
        return MaxEntIRL(cfg)
    if stage in STAGES:
        raise NotImplementedError(f"stage {stage!r} is not ported yet")
    raise ValueError(f"Unknown stage: {stage} (expected one of {STAGES})")


def model_inputs(stage: str, batch: dict) -> tuple:
    """Positional model args for a stage from the batch dict."""
    rgbd = batch["image"]
    p2p = batch["p2p"]
    if stage in ("depth", "distillation"):
        return (rgbd, p2p)
    if stage == "ssc":
        return (rgbd, p2p, batch.get("mv_mask", None))
    return (rgbd, p2p, batch.get("traversability_label", None))


def merge_tensor_dict(batch: dict, outputs: dict,
                      task: str | None = None) -> dict:
    td: dict = {}
    for k, v in batch.items():
        td[f"inputs/{k}"] = v
    for k, v in outputs.items():
        td[f"outputs/{k}"] = v
    if task is not None:
        td["task"] = task
    return td


def loss_metrics(loss_dict: dict, meta: dict) -> dict[str, torch.Tensor]:
    """The weighted losses and the scalar metadata, as the JAX step logs
    them."""
    metrics = {k: w * v for k, (w, v) in loss_dict.items()}
    metrics.update({k: v for k, v in meta.items() if v.ndim == 0})
    return metrics


def make_loss_closure(stage: str, model: MaxEntIRL,
                      loss_manager: LossManager,
                      task: str | None = None) -> LossClosure:
    """loss_and_metrics(batch, drop_connect) -> (total, metrics), with the
    model in whatever mode the caller set (``train_step`` sets training).
    Stage 3 hands the losses ``model.reward`` as the penalty's
    ``reward_fn``: the reward net in its eval form, on the running
    statistics from before the step (pipelines.py:154-160 of the JAX
    package)."""
    if stage != "traversability":
        raise NotImplementedError(f"stage {stage!r} is not ported yet")

    def loss_and_metrics(batch: dict, drop_connect: DropConnect):
        outputs = model(*model_inputs(stage, batch),
                        drop_connect=drop_connect)
        td = merge_tensor_dict(batch, outputs, task)
        loss_dict, meta = loss_manager(td, {"reward_fn": model.reward})
        return LossManager.total(loss_dict), loss_metrics(loss_dict, meta)

    return loss_and_metrics


def init_stage(stage: str, cfg: Any, seed: int = 0,
               steps_per_epoch: int = 100, frozen_pred=None,
               device: str | torch.device = "cuda"
               ) -> tuple[MaxEntIRL, LossManager, TrainState]:
    """(model, loss_manager, state) for a stage, with seeded random weights
    (``weights.init_weights``) on ``device``.

    frozen_pred: a path predicate marking frozen parameters (see
    ``optim.LOAD_SETTING_FROZEN``); stage 3 defaults to freezing the whole
    backbone (lfd.py:81-90 of the reference)."""
    dev = resolve_device(device)
    cfg = cfg.to_dict() if hasattr(cfg, "to_dict") else cfg
    model = weights.init_weights(build_model(stage, cfg), seed).to(dev)
    loss_manager = LossManager(cfg)
    if frozen_pred is None and stage == "traversability":
        frozen_pred = lambda p: p.startswith("backbone")  # noqa: E731
    opt, sched = optim.make_optimizer(
        cfg.get("optimizer", {}), cfg.get("lr_scheduler", {}),
        steps_per_epoch, optim.freeze(model, frozen_pred))
    return model, loss_manager, TrainState(0, model, opt, sched)


def make_train_step(stage: str, model: MaxEntIRL, loss_manager: LossManager,
                    task: str | None = None
                    ) -> Callable[[TrainState, dict, DropConnect], dict]:
    """step(state, batch, drop_connect) -> metrics (``state.train_step``
    over this stage's loss closure). ``batch`` holds tensors on the
    model's device."""
    loss_fn = make_loss_closure(stage, model, loss_manager, task)

    def step(state: TrainState, batch: dict,
             drop_connect: DropConnect) -> dict:
        return train_step(state, loss_fn, batch, drop_connect)

    return step
