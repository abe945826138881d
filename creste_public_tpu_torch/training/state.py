"""Single-device train state and training step.

Counterpart of ``creste_public_tpu/training/state.py`` on one device: the
state is the step count, the model (parameters and BatchNorm running
statistics), the optimizer and its LR scheduler. Data parallelism (the JAX
package's ``shard_map`` step with gradients and running statistics
``pmean``-ed over the mesh) is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch import nn

from creste_public_tpu_torch.models.blocks.convnets import (
    commit_batch_stats,
    discard_batch_stats,
)
from creste_public_tpu_torch.models.blocks.effnet import DropConnect

# (batch, drop_connect) -> (total loss, {name: 0-dim tensor})
LossClosure = Callable[[dict, DropConnect],
                       tuple[torch.Tensor, dict[str, torch.Tensor]]]


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
               drop_connect: DropConnect) -> dict[str, torch.Tensor]:
    """One step in place: the model in training mode computes the loss and
    its gradient, Adam steps the trainable parameters, then the BatchNorm
    running statistics the forward staged are committed (after the loss,
    so that an eval-form call inside it saw the pre-step ones). Returns the
    metrics with ``grad_norm`` (over every gradient; frozen parameters have
    none and count 0) and ``loss``, as 0-dim tensors on the model's
    device."""
    model, opt = state.model, state.optimizer
    model.train()
    discard_batch_stats(model)
    opt.zero_grad(set_to_none=True)
    loss, metrics = loss_fn(batch, drop_connect)
    loss.backward()
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    metrics = {k: v.detach() for k, v in metrics.items()}
    metrics["grad_norm"] = (global_norm(grads) if grads
                            else torch.zeros((), device=loss.device))
    opt.step()
    state.scheduler.step()
    commit_batch_stats(model)
    state.step += 1
    metrics["loss"] = loss.detach()
    return metrics
