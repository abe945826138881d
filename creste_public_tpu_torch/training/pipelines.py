"""Stage pipelines: model + LossManager + optimizer -> training step.

Counterpart of ``creste_public_tpu/training/pipelines.py``: the positional
model arguments of a stage, the merged tensor dict that the losses read
(``inputs/<batch key>``, ``outputs/<model key>``, ``task``), the loss
closure (stage 2 hands SupCon its priority source, stage 3 the IRL
penalty's ``reward_fn``), ``init_stage`` and ``make_train_step`` with the
epoch-scheduled backbone freeze, for the four stages: ``depth`` (0),
``distillation`` (1), ``ssc`` (2) and ``traversability`` (3); and for
sequence-chunked stage-2 training ``make_temporal_train_step`` with the
ConvGRU hidden state carried between chunks, and ``init_temporal_hidden``.

With a model config's ``compute_dtype`` (``"bfloat16"``) a step runs the
mixed-precision forward of ``mixed_precision_forward``: the optimizer's
master parameters stay f32, bf16 copies of them drive the forward and carry
the gradient back, and the outputs, the losses and the BatchNorm
statistics are f32 (pipelines.py:85-150 of the JAX package).
"""
from __future__ import annotations

import functools
from typing import Any, Callable

import torch
from torch import nn

from creste_public_tpu_torch import weights
from creste_public_tpu_torch.losses.manager import LossManager
from creste_public_tpu_torch.losses.supcon import PrioritySource
from creste_public_tpu_torch.models.blocks.convnets import eval_form
from creste_public_tpu_torch.models.blocks.effnet import DropConnect
from creste_public_tpu_torch.models.depth_completion import (
    DepthCompletion,
    DepthCompletionModel,
)
from creste_public_tpu_torch.models.distillation import DistillationBackbone
from creste_public_tpu_torch.models.lfd import MaxEntIRL
from creste_public_tpu_torch.models.terrainnet import TerrainNet
from creste_public_tpu_torch.parallel import Group
from creste_public_tpu_torch.runtime.precision import batch_norm_keys
from creste_public_tpu_torch.training import optim
from creste_public_tpu_torch.training.state import (
    GradTransform,
    LossClosure,
    TrainState,
    train_step,
)
from creste_public_tpu_torch.utils.device import resolve_device

_MODELS = {"depth": DepthCompletionModel,
           "distillation": DistillationBackbone, "ssc": TerrainNet,
           "traversability": MaxEntIRL}
STAGES = tuple(_MODELS)


def build_model(stage: str, cfg: Any) -> nn.Module:
    cfg = cfg.to_dict() if hasattr(cfg, "to_dict") else cfg
    if stage not in _MODELS:
        raise ValueError(f"Unknown stage: {stage} (expected one of {STAGES})")
    return _MODELS[stage](cfg)


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


def priority_source(drop_connect: DropConnect,
                    priorities: PrioritySource = None) -> PrioritySource:
    """SupCon's priority source for a step: ``priorities`` when given, else
    the step's own generator, drawn after the drop-connect masks (the JAX
    step hands one key to both); None for a fed mask source."""
    if priorities is not None:
        return priorities
    return drop_connect if isinstance(drop_connect, torch.Generator) else None


def loss_aux(stage: str, model: nn.Module,
             priorities: PrioritySource | dict = None,
             group: Group = None) -> dict:
    """The ``aux`` a stage's losses read: stage 3 the IRL penalty's
    ``reward_fn`` (``model.reward``: the reward net in its eval form, on
    the running statistics from before the step, pipelines.py:154-160 of
    the JAX package); stage 2 the sampling losses' priority source, which
    it needs (``{"rng": priorities}``, or ``priorities`` itself when it is
    a dict of such entries: fed priorities for SupCon under ``rng`` and
    for VICReg under ``vicreg_rng``); stages 0 and 1 nothing (no loss of
    theirs draws at random). Under data parallelism every stage's ``aux``
    also holds the ranks' ``group`` (the JAX package's ``axis_name``,
    which SupCon gathers over)."""
    aux = {} if group is None else {"group": group}
    if stage == "traversability":
        return dict(aux, reward_fn=model.reward)
    if stage != "ssc":
        return aux
    if priorities is None:
        raise ValueError("stage 2 needs SupCon's priorities: give the step a "
                         "torch.Generator or pass priorities=")
    return dict(aux, **(priorities if isinstance(priorities, dict)
                        else {"rng": priorities}))


def mixed_precision_forward(stage: str, model: nn.Module
                            ) -> Callable[..., dict]:
    """The forward a training step calls: ``model`` itself, or, when the
    model was built with a ``compute_dtype`` (its ``DepthCompletion``'s),
    a call through ``torch.func.functional_call`` with bf16 copies
    (``p.to(dtype)``, so the gradient reaches the f32 master) of the
    parameters that ``precision.cast_state`` casts: for stage 3 only the
    frozen backbone's (its forward carries no gradient; the reward net,
    VI, SVF and the penalty stay f32), for the other stages every one. The
    input is not cast (the EffNet stem reads it in f32); the float outputs
    come back f32, and the BatchNorms stage f32 statistics."""
    dtype = next((m.compute_dtype for m in model.modules()
                  if isinstance(m, DepthCompletion)), None)
    if dtype is None:
        return model
    keep = batch_norm_keys(model.state_dict())
    names = [n for n, p in model.named_parameters()
             if n not in keep and p.is_floating_point()
             and (stage != "traversability" or n.startswith("backbone."))]

    def forward(*args, **kwargs) -> dict:
        params = dict(model.named_parameters())
        cast = {n: params[n].to(dtype) for n in names}
        out = torch.func.functional_call(model, cast, args, kwargs)
        return {k: v.float() if isinstance(v, torch.Tensor)
                and v.is_floating_point() else v for k, v in out.items()}

    return forward


def make_loss_closure(stage: str, model: nn.Module,
                      loss_manager: LossManager,
                      task: str | None = None,
                      group: Group = None) -> Callable[..., Any]:
    """loss_and_metrics(batch, drop_connect, priorities=None) -> (total,
    metrics), with the model in whatever mode the caller set
    (``train_step`` sets training) and the stage's ``loss_aux`` (with the
    ranks' ``group`` under data parallelism); in the
    model's ``compute_dtype`` where it has one
    (``mixed_precision_forward``)."""
    forward = mixed_precision_forward(stage, model)

    def loss_and_metrics(batch: dict, drop_connect: DropConnect,
                         priorities: PrioritySource = None):
        outputs = forward(*model_inputs(stage, batch),
                          drop_connect=drop_connect)
        td = merge_tensor_dict(batch, outputs, task)
        aux = loss_aux(stage, model, priority_source(drop_connect,
                                                     priorities), group)
        loss_dict, meta = loss_manager(td, aux)
        return LossManager.total(loss_dict), loss_metrics(loss_dict, meta)

    return loss_and_metrics


def init_stage(stage: str, cfg: Any, seed: int = 0,
               steps_per_epoch: int = 100, frozen_pred=None,
               device: str | torch.device = "cuda"
               ) -> tuple[nn.Module, LossManager, TrainState]:
    """(model, loss_manager, state) for a stage, with seeded random weights
    (``weights.init_weights``) on ``device``.

    frozen_pred: a path predicate marking frozen parameters (see
    ``optim.LOAD_SETTING_FROZEN``); stage 3 defaults to freezing the whole
    backbone (lfd.py:81-90 of the reference), which no gradient reaches,
    so it records none."""
    dev = resolve_device(device)
    cfg = cfg.to_dict() if hasattr(cfg, "to_dict") else cfg
    model = weights.init_weights(build_model(stage, cfg), seed).to(dev)
    loss_manager = LossManager(cfg)
    if frozen_pred is None and stage == "traversability":
        frozen_pred = lambda p: p.startswith("backbone")  # noqa: E731
    opt, sched = optim.make_optimizer(
        cfg.get("optimizer", {}), cfg.get("lr_scheduler", {}),
        steps_per_epoch, optim.freeze(
            model, frozen_pred, record_grads=stage != "traversability"))
    return model, loss_manager, TrainState(0, model, opt, sched)


def backbone_freeze_gate(grads: dict[str, torch.Tensor],
                         batch: dict) -> dict[str, torch.Tensor]:
    """The epoch-scheduled backbone freeze (train_ssc.py:56-80 of the
    reference): every ``depthcomp.*`` gradient times the batch's 0/1
    ``_backbone_unfrozen`` gate. The gradients stay zero tensors, so Adam
    still steps those parameters (its moments decay, its count advances),
    as after optax's ``set_to_zero``. A batch without the gate raises."""
    if "_backbone_unfrozen" not in batch:
        raise KeyError("the scheduled backbone freeze needs the batch's "
                       "_backbone_unfrozen gate")
    gate = batch["_backbone_unfrozen"]
    return optim.scheduled_freeze_gate(
        grads, lambda p: p.startswith("depthcomp"), gate.reshape(-1)[0])


def make_train_step(stage: str, model: nn.Module, loss_manager: LossManager,
                    task: str | None = None,
                    freeze_backbone_schedule: bool = False,
                    group: Group = None) -> Callable[..., dict]:
    """step(state, batch, drop_connect, priorities=None) -> metrics
    (``state.train_step`` over this stage's loss closure). ``batch`` holds
    tensors on the model's device (this rank's rows under data
    parallelism, with ``group`` the ranks' process group). With
    ``freeze_backbone_schedule`` every batch carries the
    ``_backbone_unfrozen`` gate (``backbone_freeze_gate``)."""
    loss_fn = make_loss_closure(stage, model, loss_manager, task, group)
    transform: GradTransform | None = (
        backbone_freeze_gate if freeze_backbone_schedule else None)

    def step(state: TrainState, batch: dict, drop_connect: DropConnect,
             priorities: PrioritySource = None) -> dict:
        closure: LossClosure = functools.partial(loss_fn,
                                                 priorities=priorities)
        return train_step(state, closure, batch, drop_connect, transform,
                          group)

    return step


def make_temporal_train_step(model: nn.Module, loss_manager: LossManager,
                             task: str | None = None,
                             group: Group = None) -> Callable[..., Any]:
    """The sequence-chunked stage-2 step (``make_temporal_train_step`` of
    the JAX package): step(state, batch, hidden, bos,
    drop_connect, priorities=None, pose_noise=None) -> (state, metrics,
    new_hidden). The model reads the chunk's ``image`` and ``p2p`` [B, T,
    ...] and its ``pose`` (with ``use_pose``), and no movability mask;
    ``bos`` is a Python bool: True starts the sequence from a zero hidden
    state and ignores ``hidden``. The returned hidden state is out of the
    graph (the reference's detached cross-chunk state). Pose noise comes
    from ``pose_noise``, else from the step's generator after the
    drop-connect masks, as SupCon's priorities do. The metrics are the
    JAX step's: the weighted losses, the scalar metadata and ``loss``.
    Under data parallelism (``group``) ``batch`` and ``hidden`` are this
    rank's rows: the hidden state stays per rank, the gradients, running
    statistics and metrics are means over the ranks."""

    def loss_fn(batch: dict, drop_connect: DropConnect,
                priorities: PrioritySource | dict, pose_noise, hidden,
                bos: bool, carry: dict):
        outputs = model(batch["image"], batch["p2p"], None,
                        drop_connect=drop_connect, temporal_hidden=hidden,
                        bos=bos, pose=batch.get("pose", None),
                        pose_noise=pose_noise)
        carry["hidden"] = outputs["temporal_hidden"]
        td = merge_tensor_dict(batch, outputs, task)
        loss_dict, meta = loss_manager(td, loss_aux(
            "ssc", model, priority_source(drop_connect, priorities), group))
        return LossManager.total(loss_dict), loss_metrics(loss_dict, meta)

    def step(state: TrainState, batch: dict, hidden, bos: bool,
             drop_connect: DropConnect,
             priorities: PrioritySource | dict = None, pose_noise=None):
        if pose_noise is None and isinstance(drop_connect, torch.Generator):
            pose_noise = drop_connect
        carry: dict = {}
        closure: LossClosure = functools.partial(
            loss_fn, priorities=priorities, pose_noise=pose_noise,
            hidden=hidden, bos=bool(bos), carry=carry)
        metrics = train_step(state, closure, batch, drop_connect,
                             group=group)
        del metrics["grad_norm"]
        return state, metrics, carry["hidden"]

    return step


@torch.no_grad()
def init_temporal_hidden(model: nn.Module, sample_batch: dict) -> list:
    """A zero hidden state of the right shapes (one eval forward of the
    sample batch, its ``pose`` passed where it has one, pose noise from a
    throwaway generator: the values are zeroed), the model's modes
    restored after it."""
    with eval_form(model):
        outputs = model(sample_batch["image"], sample_batch["p2p"], None,
                        pose=sample_batch.get("pose", None),
                        pose_noise=torch.Generator().manual_seed(0))
    return [tuple(torch.zeros_like(t) for t in h) if isinstance(h, tuple)
            else torch.zeros_like(h) for h in outputs["temporal_hidden"]]
