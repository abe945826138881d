"""Train state and the (data-parallel) training step.

Counterpart of ``creste_public_tpu/training/state.py``: the state is the
step count, the model (parameters and BatchNorm running statistics), the
optimizer and its LR scheduler. Under data parallelism every rank holds the
whole state and steps it on its rows of the batch; the step means the
gradients and the running statistics over the ranks, as the JAX package's
``shard_map`` step ``pmean``s them, while each rank's BatchNorms normalise
with their own batch statistics (DDP's unsynced BatchNorm). Neither
``DistributedDataParallel`` (whose ``broadcast_buffers`` would make the
running statistics rank 0's, not their mean) nor ``SyncBatchNorm`` (which
shares the batch statistics) has these semantics.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch import nn

from creste_public_tpu_torch.models.blocks.convnets import (
    BatchNorm,
    commit_batch_stats,
    discard_batch_stats,
)
from creste_public_tpu_torch.models.blocks.effnet import DropConnect
from creste_public_tpu_torch.parallel import Group, all_reduce_mean

# (batch, drop_connect) -> (total loss, {name: 0-dim tensor})
LossClosure = Callable[[dict, DropConnect],
                       tuple[torch.Tensor, dict[str, torch.Tensor]]]
# ({name: gradient}, batch) -> {name: gradient}
GradTransform = Callable[[dict[str, torch.Tensor], dict],
                         dict[str, torch.Tensor]]


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler


def global_norm(grads: list[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every entry (``optax.global_norm``)."""
    return torch.sqrt(sum((g.float() * g.float()).sum() for g in grads))


def train_step(state: TrainState, loss_fn: LossClosure, batch: dict,
               drop_connect: DropConnect,
               grad_transform: GradTransform | None = None,
               group: Group = None) -> dict[str, torch.Tensor]:
    """One step in place: the model in training mode computes the loss and
    its gradient, ``grad_transform`` (the scheduled backbone freeze) maps
    the gradients, Adam steps the trainable parameters, then the BatchNorm
    running statistics the forward staged are committed (after the loss,
    so that an eval-form call inside it saw the pre-step ones). Returns the
    metrics with ``grad_norm`` and ``loss``, as 0-dim tensors on the
    model's device.

    As optax does, Adam steps every parameter it holds: one that the loss
    did not reach gets a zero gradient, so that its moments decay and its
    step count advances. ``grad_norm`` is taken after the transform over
    every gradient, a frozen parameter's included where it records one
    (``optim.freeze``); a parameter that records none counts 0, which is
    what the JAX step's stop-gradient gives it.

    With a ``group`` (data parallelism; ``batch`` is this rank's rows) the
    order is the JAX step's: the transform, the mean over the ranks of
    every gradient (zero-filled ones included), ``grad_norm`` of the means,
    Adam, the commit of this rank's statistics, then their mean over the
    ranks; the metrics and ``loss`` are means over the ranks too."""
    model, opt = state.model, state.optimizer
    model.train()
    discard_batch_stats(model)
    model.zero_grad(set_to_none=True)
    loss, metrics = loss_fn(batch, drop_connect)
    loss.backward()
    for param_group in opt.param_groups:
        for p in param_group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
    named = {k: p for k, p in model.named_parameters() if p.grad is not None}
    if grad_transform is not None:
        for k, g in grad_transform({k: p.grad for k, p in named.items()},
                                   batch).items():
            named[k].grad = g
    all_reduce_mean([p.grad for p in named.values()], group)
    metrics = {k: v.detach() for k, v in metrics.items()}
    metrics["grad_norm"] = (global_norm([p.grad for p in named.values()])
                            if named else torch.zeros((), device=loss.device))
    opt.step()
    state.scheduler.step()
    commit_batch_stats(model)
    all_reduce_mean(running_stats(model), group)
    state.step += 1
    metrics["loss"] = loss.detach()
    mean_metrics(metrics, group)
    return metrics


def running_stats(model: nn.Module) -> list[torch.Tensor]:
    """Every BatchNorm's running mean and variance, in module order."""
    return [t for m in model.modules() if isinstance(m, BatchNorm)
            for t in (m.running_mean, m.running_var)]


def mean_metrics(metrics: dict[str, torch.Tensor], group: Group) -> None:
    """Each (0-dim) metric replaced by its mean over the ranks, in place
    (no-op without a group)."""
    if group is None:
        return
    keys = sorted(metrics)
    vals = [metrics[k].reshape(1).to(torch.promote_types(
        metrics[k].dtype, torch.float32)) for k in keys]
    all_reduce_mean(vals, group)
    metrics.update({k: v.reshape(metrics[k].shape)
                    for k, v in zip(keys, vals)})
