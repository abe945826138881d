"""Optimizer, LR schedule and parameter-freeze policies.

Counterpart of ``creste_public_tpu/training/optim.py``. The predicates take
the port's parameter names, which are the flax scope paths joined by ``.``
instead of ``/`` (``backbone.bevclassifier.head_0.proj.weight``), so each
JAX predicate carries over with its separator changed.

A frozen parameter is left out of the optimizer, which gives what the JAX
package's ``optax.masked(set_to_zero())`` gives it: no update. The JAX
step still computes its gradient and counts it in ``grad_norm``, so where
the loss reaches a frozen parameter (stage 2 under a freezing load
setting) it keeps ``requires_grad`` (``record_grads``); where no gradient
can reach it (stage 3's backbone, behind the detached input view)
``requires_grad_(False)`` gives the same zero and keeps autograd from
recording its forward.
"""
from __future__ import annotations

import re
from typing import Any, Callable, Iterable, Mapping

import torch
from torch import nn

PathPred = Callable[[str], bool]


class ParamsPredFactory:
    """A frozen-predicate that needs the parameters to resolve: call it with
    the named parameters to obtain the PathPred (``freeze_mask`` does)."""

    def __init__(self, fn: Callable[[Mapping[str, torch.Tensor]], PathPred]):
        self._fn = fn

    def __call__(self, params: Mapping[str, torch.Tensor]) -> PathPred:
        return self._fn(params)


_PROJ = re.compile(r"(?:^|\.)bevclassifier\.(head_\d+)\.proj\.weight$")


def _ft_semantic_head_frozen(params: Mapping[str, torch.Tensor]) -> PathPred:
    """Everything freezes except parameters named ``bev_semantic_head`` and
    all parameters of the decoder heads whose 1x1 ``proj`` has one output
    channel (terrainnet.py:154-170 of the reference)."""
    one_ch = set()
    for name, p in params.items():
        m = _PROJ.search(name)
        if m and p.shape[0] == 1:
            one_ch.add(m.group(1))
    return lambda p: not (
        "bev_semantic_head" in p
        or any(f"bevclassifier.{h}." in p for h in one_ch)
    )


# Freeze-policy predicates keyed by the reference's load_setting names.
LOAD_SETTING_FROZEN: dict[str, PathPred | ParamsPredFactory | None] = {
    "strict": None,
    "strict_freeze": lambda p: True,
    "strict_unfreezesplat": lambda p: "cam2map" not in p,
    "ft_semantic_head": ParamsPredFactory(_ft_semantic_head_frozen),
    "ft_decoders_all": lambda p: not (
        "bevclassifier" in p and ("head_" in p)
    ),
    "ft_decoders_partial": lambda p: not (
        "bevclassifier" in p
        and "head_" in p
        and ("up2" in p or "proj" in p)
    ),
}


def freeze_mask(params: Mapping[str, torch.Tensor],
                frozen_pred: PathPred | ParamsPredFactory | None
                ) -> dict[str, bool]:
    """{name: True where the parameter is trainable}."""
    if frozen_pred is None:
        return {k: True for k in params}
    if isinstance(frozen_pred, ParamsPredFactory):
        frozen_pred = frozen_pred(params)
    return {k: not frozen_pred(k) for k in params}


def freeze(model: nn.Module,
           frozen_pred: PathPred | ParamsPredFactory | None,
           record_grads: bool = False) -> list[nn.Parameter]:
    """The trainable parameters of ``model``, in ``named_parameters``
    order. A frozen one keeps ``requires_grad`` (its gradient counts in
    ``grad_norm``) when ``record_grads``, else gets
    ``requires_grad_(False)``."""
    params = dict(model.named_parameters())
    mask = freeze_mask(params, frozen_pred)
    for k, p in params.items():
        p.requires_grad_(mask[k] or record_grads)
    return [p for k, p in params.items() if mask[k]]


def scheduled_freeze_gate(grads: Mapping[str, torch.Tensor], pred: PathPred,
                          unfrozen: Any) -> dict[str, torch.Tensor]:
    """Gradients of the parameters matching ``pred`` times the 0/1 gate
    ``unfrozen`` (the epoch-scheduled freeze of stage 2)."""
    gate = torch.as_tensor(unfrozen, dtype=torch.float32)
    return {k: g * gate.to(g.device) if pred(k) else g
            for k, g in grads.items()}


def make_optimizer(opt_cfg: Any, sched_cfg: Any, steps_per_epoch: int,
                   params: Iterable[nn.Parameter]
                   ) -> tuple[torch.optim.Adam, torch.optim.lr_scheduler.LambdaLR]:
    """Adam over ``params`` with a per-epoch staircase decay: at optimizer
    step ``t`` (counted before the update) the rate is
    ``lr * gamma ** (t // steps_per_epoch)``, optax's
    ``exponential_decay(staircase=True)``. Step the scheduler once after
    each optimizer step. Adam's update ``m_hat / (sqrt(v_hat) + eps)`` is
    optax's."""
    name = opt_cfg.get("name", "Adam")
    if name != "Adam":
        raise NotImplementedError(name)
    lr = float(opt_cfg.get("lr", 5e-4))
    gamma = float(sched_cfg.get("gamma", 1.0)) if sched_cfg else 1.0
    spe = max(int(steps_per_epoch), 1)
    opt = torch.optim.Adam(
        params, lr=lr,
        betas=(float(opt_cfg.get("beta1", 0.9)),
               float(opt_cfg.get("beta2", 0.999))),
        eps=float(opt_cfg.get("eps", 1e-8)))
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda t: gamma ** (t // spe))
    return opt, sched
