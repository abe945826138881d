"""Generic conv stacks (PyTorch, NCHW inside).

Counterpart of ``creste_public_tpu/models/blocks/convnets.py``. Submodules
carry the flax scope names (``Conv_0``, ``BatchNorm_0``, ``prepool_0``, ...)
so that ``weights.from_jax_variables`` maps a flax tree by a short rule
table. Inference only: every BatchNorm uses its running statistics.
"""
from __future__ import annotations

from typing import Any, Sequence

import torch
import torch.nn.functional as F
from torch import nn


class BatchNorm(nn.Module):
    """The eval form of the JAX package's ``batch_norm``, over dim 1:
    ``(x - mean) / sqrt(var + eps) * weight + bias``. eps 1e-5 is its
    default; the EfficientNet blocks pass 1e-3."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x.float(), self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0,
                            self.eps).to(x.dtype)


class ConvLayer(nn.Module):
    """conv(k, s, pad k//2) [+ BN] [+ ReLU] (reference conv.py:63-85)."""

    def __init__(self, in_ch: int, features: int, kernel: int = 3,
                 stride: int = 1, use_norm: bool = False,
                 norm_type: str = "batch_norm", relu: bool = True,
                 use_bias: bool = False):
        super().__init__()
        if use_norm and norm_type != "batch_norm":
            raise NotImplementedError(f"norm type {norm_type}")
        self.Conv_0 = nn.Conv2d(in_ch, features, kernel, stride,
                                padding=kernel // 2, bias=use_bias)
        if use_norm:
            self.BatchNorm_0 = BatchNorm(features)
        self.use_norm = use_norm
        self.relu = relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Conv_0(x)
        if self.use_norm:
            x = self.BatchNorm_0(x)
        return F.relu(x) if self.relu else x


class MultiLayerConv(nn.Module):
    """Stack of conv(+bias) -> [BN] -> ReLU layers (reference conv.py:5-32).

    cfg keys: dims (len L+1), kernels, paddings, stride (optional),
    norm_type.
    """

    def __init__(self, cfg: Any):
        super().__init__()
        kernels = list(cfg["kernels"])
        paddings = list(cfg["paddings"])
        dims = list(cfg["dims"])
        strides = list(cfg.get("stride", [1] * len(kernels)))
        self.norm = cfg.get("norm_type", None) == "batch_norm"
        self.n = len(kernels)
        for i, k in enumerate(kernels):
            self.add_module(f"Conv_{i}", nn.Conv2d(
                dims[i], dims[i + 1], k, strides[i], padding=paddings[i]))
            if self.norm:
                self.add_module(f"BatchNorm_{i}", BatchNorm(dims[i + 1]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            x = getattr(self, f"Conv_{i}")(x)
            if self.norm:
                x = getattr(self, f"BatchNorm_{i}")(x)
            x = F.relu(x)
        return x


class ConvEncoder(MultiLayerConv):
    """MultiLayerConv without a stride entry (reference conv.py:37-58)."""

    def __init__(self, cfg: Any):
        super().__init__({k: v for k, v in cfg.items() if k != "stride"})


class MLP(nn.Module):
    """Dense layers with ReLU after every one, on the last axis (z_proj of
    the splat, splat_projection.py:98-104)."""

    def __init__(self, in_dim: int, dims: Sequence[int]):
        super().__init__()
        self.n = len(dims)
        for i, d in enumerate(dims):
            self.add_module(f"Dense_{i}", nn.Linear(in_dim, d))
            in_dim = d

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            x = F.relu(getattr(self, f"Dense_{i}")(x))
        return x


def resize_bilinear(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """Bilinear resize of NCHW ``x`` to ``size`` (half-pixel centres).

    Equals ``jax.image.resize(..., "bilinear")`` when upsampling, which is
    the only way the graph uses it: both sample at ``(o + 0.5) * in/out -
    0.5`` and renormalise at the edges. (Downsampling differs: JAX widens
    its kernel to antialias.) The output size is passed, never a scale
    factor, so that odd sizes such as 153 match.
    """
    return F.interpolate(x, size=tuple(int(s) for s in size),
                         mode="bilinear", align_corners=False)


def upsample_bilinear(x: torch.Tensor, scale: float) -> torch.Tensor:
    """Bilinear upsample of NCHW ``x`` to ``floor(in * scale)``."""
    H, W = x.shape[-2:]
    return resize_bilinear(x, (int(H * scale), int(W * scale)))


class MultiScaleFCN(nn.Module):
    """Reward network: prepool -> (skip || maxpool-trunk-upsample) -> concat
    -> postpool (reference conv.py:88-161). Bias-free convs, BN + ReLU
    throughout; each trunk layer is conv + ReLU, then BN + ReLU."""

    def __init__(self, cfg: Any):
        super().__init__()
        self.cfg = cfg

        def stack(name, sub):
            kernels = list(sub["kernels"])
            dims = list(sub["dims"])
            strides = list(sub.get("stride", [1] * len(kernels)))
            for i, k in enumerate(kernels):
                self.add_module(f"{name}_{i}", ConvLayer(
                    dims[i], dims[i + 1], k, strides[i], use_norm=True,
                    norm_type=sub.get("norm_type", "batch_norm")))
            return len(kernels)

        self.n_prepool = stack("prepool", cfg["prepool"])
        self.n_skip = stack("skip", cfg["skip"])
        self.n_postpool = stack("postpool", cfg["postpool"])
        trunk = cfg["trunk"]
        dims = list(trunk["dims"])
        self.trunk_bn = trunk.get("norm_type") == "batch_norm"
        self.n_trunk = len(trunk["kernels"])
        for i, k in enumerate(trunk["kernels"]):
            self.add_module(f"trunk_{i}", ConvLayer(
                dims[i], dims[i + 1], k, use_norm=False))
            if self.trunk_bn:
                self.add_module(f"trunk_bn_{i}", BatchNorm(dims[i + 1]))

    def _run(self, name: str, n: int, x: torch.Tensor) -> torch.Tensor:
        for i in range(n):
            x = getattr(self, f"{name}_{i}")(x)
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self._run("prepool", self.n_prepool, x)
        skip = self._run("skip", self.n_skip, x)
        t = F.max_pool2d(x, 2, 2)
        for i in range(self.n_trunk):
            t = getattr(self, f"trunk_{i}")(t)
            if self.trunk_bn:
                t = F.relu(getattr(self, f"trunk_bn_{i}")(t))
        t = upsample_bilinear(t, 2)
        x = torch.cat([t, skip], dim=1)
        return self._run("postpool", self.n_postpool, x)
