"""Weights for the port: import from a flax variable tree, or a seeded init.

The port's submodules carry the flax scope names, so a flax leaf maps to a
state_dict key by one rule table:

  params/<path>/kernel  4-D HWIO -> <path>.weight OIHW (a depthwise HWI1
                        kernel becomes (C, 1, kh, kw), as groups=C wants)
  params/<path>/kernel  2-D (in, out) -> <path>.weight (out, in)
  params/<path>/bias    -> <path>.bias
  params/<path>/scale   -> <path>.weight  (BatchNorm, GroupNorm, LayerNorm)
  batch_stats/<path>/mean -> <path>.running_mean
  batch_stats/<path>/var  -> <path>.running_var
  params/<path>/learnable_pe_map  NHWC [1, h, w, C] -> <path>.learnable_pe_map
                        NCHW [1, C, h, w]   (the PE-free distillation map)
  params/<path>/log_var -> <path>.log_var   (the decoder's learnable loss
                        weight)
  params/<path>/{cls_token,pos_embed,ls1,ls2} -> <path>.<leaf>, as stored
                        (the ViT's tokens, position table and LayerScale)
  params/<path>/GroupNorm_0/{scale,bias} -> <path>.GroupNorm_0.{weight,bias}
                        (by the scale and bias rules above)

A grouped conv's HWIO kernel [kh, kw, in / groups, out] becomes torch's
[out, in / groups, kh, kw] by the same transpose (the merged decoder heads'
``mh_*`` convs), and a Dense kernel [in, out] a Linear weight [out, in]
(the temporal layer's ``z_map_*``).
"""
from __future__ import annotations

import math
from typing import Mapping

import numpy as np
import torch
from torch import nn

from creste_public_tpu_torch.models.blocks.convnets import BatchNorm

_PARAM_LEAVES = {"kernel": "weight", "bias": "bias", "scale": "weight"}
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}
_PE_MAP = "learnable_pe_map"
_LOG_VAR = "log_var"
_AS_STORED = {"cls_token", "pos_embed", "ls1", "ls2"}


def from_jax_variables(flat: Mapping[str, np.ndarray]
                       ) -> dict[str, torch.Tensor]:
    """Map a flattened flax variable tree (``"params/a/b/kernel"`` ->
    array) to a state_dict. Raises on a leaf no rule takes and on two
    leaves that land on one key; ``load_state_dict(strict=True)`` then
    catches what is missing or left over."""
    sd: dict[str, torch.Tensor] = {}
    for key, arr in flat.items():
        coll, *path, leaf = key.split("/")
        arr = np.asarray(arr, np.float32)
        if coll == "params" and leaf in _PARAM_LEAVES:
            if leaf == "kernel":
                if arr.ndim == 4:
                    arr = arr.transpose(3, 2, 0, 1)
                elif arr.ndim == 2:
                    arr = arr.T
                else:
                    raise ValueError(f"{key}: kernel of rank {arr.ndim}")
            name = _PARAM_LEAVES[leaf]
        elif coll == "params" and leaf == _PE_MAP and arr.ndim == 4:
            arr, name = arr.transpose(0, 3, 1, 2), _PE_MAP
        elif coll == "params" and leaf == _LOG_VAR and arr.ndim == 1:
            name = _LOG_VAR
        elif coll == "params" and leaf in _AS_STORED:
            name = leaf
        elif coll == "batch_stats" and leaf in _STAT_LEAVES:
            name = _STAT_LEAVES[leaf]
        else:
            raise ValueError(f"{key}: no rule maps this leaf")
        tkey = ".".join([*path, name])
        if tkey in sd:
            raise ValueError(f"{key}: a second leaf for {tkey}")
        sd[tkey] = torch.from_numpy(np.array(arr, np.float32, order="C"))
    return sd


def load_jax_variables(module: nn.Module,
                       flat: Mapping[str, np.ndarray]) -> nn.Module:
    """``from_jax_variables`` + ``load_state_dict(strict=True)``."""
    module.load_state_dict(from_jax_variables(flat), strict=True)
    return module


@torch.no_grad()
def init_weights(module: nn.Module, seed: int) -> nn.Module:
    """Seeded random weights, made on the CPU with a ``torch.Generator``.

    Conv and dense weights are lecun-normal (std 1/sqrt(fan_in), the flax
    default), biases zero, BN scale 1 and bias 0. BN running statistics are
    jittered (mean |0.3 N|, var |1 + 0.3 N|) so that the reward head's BN
    fold has real work to do. A PE-free distillation map is 0.05 N, its
    flax init.
    """
    g = torch.Generator().manual_seed(seed)
    for m in module.modules():
        pe = getattr(m, _PE_MAP, None)
        if isinstance(pe, nn.Parameter):
            pe.copy_(0.05 * torch.randn(pe.shape, generator=g))
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            w = m.weight
            fan_in = w[0].numel()
            w.copy_(torch.randn(w.shape, generator=g) / math.sqrt(fan_in))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, BatchNorm):
            n = m.weight.shape[0]
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.copy_((0.3 * torch.randn(n, generator=g)).abs())
            m.running_var.copy_((1 + 0.3 * torch.randn(n, generator=g)).abs())
    return module


@torch.no_grad()
def jitter_reward_head_bns(msfcn: nn.Module, seed: int) -> nn.Module:
    """Seeded BN scales (0.5 + U[0, 1)) and shifts (0.3 + 0.3 N) for a
    MultiScaleFCN reward head, the final BN's shift 0.5 higher, so that
    most of its relus, the final one included, pass values through (with
    ``init_weights`` alone the final relu is dead)."""
    g = torch.Generator().manual_seed(seed)
    for m in msfcn.modules():
        if isinstance(m, BatchNorm):
            m.bias.copy_(0.3 + 0.3 * torch.randn(m.bias.shape, generator=g))
            m.weight.copy_(0.5 + torch.rand(m.weight.shape, generator=g))
    msfcn.postpool_0.BatchNorm_0.bias.add_(0.5)
    return msfcn
