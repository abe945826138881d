"""Mixed-precision (bfloat16) weights for the opt-in ``compute_dtype`` mode.

Counterpart of ``creste_public_tpu/runtime/precision.py``. The mode runs
the activation stream in bf16 and keeps the numerics-critical islands in
f32: the RGBD input and the EffNet stem (bf16 enters after the stem's BN +
SiLU), every BatchNorm's math, the depth head and the metric depth that
places the splat, the splat's accumulator (only ``bev_features`` goes back
to the stream dtype) and the reward head after the input view's f32
re-entry. The layers get there by promotion (``convnets.Conv2d``): a
bf16-rounded weight reading an f32 input computes in f32.

``cast_state`` casts a state_dict once, module-aware: a BatchNorm's
``weight``, ``bias``, ``running_mean`` and ``running_var`` stay f32 (the
norm's f32 math gets f32 inputs); every other float tensor (conv and dense
weights and biases, the PE-free map, ``log_var``) goes to bf16, so that
promotion keeps the stream bf16; non-float tensors are untouched. The mode
is opt-in and not held to the f32 parity bar: it trades accuracy for
bytes, and the measurement prints its deviation beside its speed.
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Any

import torch

_BN_LEAVES = ("weight", "bias", "running_mean", "running_var")


def batch_norm_keys(state: Mapping[str, torch.Tensor]) -> set[str]:
    """The keys of ``state`` that belong to a BatchNorm: the four leaves of
    every module prefix that has a ``running_mean``."""
    prefixes = {k[: -len("running_mean")] for k in state
                if k.endswith("running_mean")}
    return {p + leaf for p in prefixes for leaf in _BN_LEAVES
            if p + leaf in state}


def cast_state(state: Mapping[str, torch.Tensor],
               dtype: torch.dtype = torch.bfloat16
               ) -> dict[str, torch.Tensor]:
    """A copy of the state_dict ``state`` with every float tensor outside a
    BatchNorm cast to ``dtype`` (see the module docstring); the JAX
    package's ``cast_variables`` on the same weights gives the same tensors
    leaf by leaf."""
    keep = batch_norm_keys(state)
    return {k: v.to(dtype) if k not in keep and v.is_floating_point() else v
            for k, v in state.items()}


@torch.no_grad()
def cast_module(module: torch.nn.Module,
                dtype: torch.dtype = torch.bfloat16) -> torch.nn.Module:
    """``cast_state`` in place on a module's parameters and persistent
    buffers (its parameters stay parameters, with their ``requires_grad``;
    non-persistent buffers, the splat's geometry constants among them,
    stay as they are). Returns ``module``."""
    state = module.state_dict(keep_vars=True)
    keep = batch_norm_keys(state)
    for name, t in state.items():
        if name not in keep and t.is_floating_point():
            t.data = t.data.to(dtype)
    return module


def _leaves(tree: Any) -> list[torch.Tensor]:
    if isinstance(tree, Mapping):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [torch.as_tensor(tree)]


def max_abs_deviation(a: Any, b: Any) -> float:
    """Max |a - b| over the leaves of two trees of tensors (dicts by sorted
    key, lists, tuples), compared in f32."""
    dev = 0.0
    for x, y in zip(_leaves(a), _leaves(b)):
        d = (x.detach().float().cpu() - y.detach().float().cpu()).abs()
        dev = max(dev, float(d.max()) if d.numel() else 0.0)
    return dev
