"""Generic conv stacks (PyTorch, NCHW inside).

Counterpart of ``creste_public_tpu/models/blocks/convnets.py``. Submodules
carry the flax scope names (``Conv_0``, ``BatchNorm_0``, ``prepool_0``, ...)
so that ``weights.from_jax_variables`` maps a flax tree by a short rule
table. Every BatchNorm follows ``nn.Module.train()``/``.eval()``: batch
statistics with a staged running-stat update in training, the running
statistics in eval (see ``BatchNorm``).

Mixed precision follows flax: a conv or dense layer (``Conv2d``,
``Linear``) computes in the promotion of its input's and its weights'
dtypes, so bf16-rounded weights read an f32 input in f32 and a bf16 input
in bf16; every BatchNorm normalises in f32 and returns its input's dtype.
After ``fold_batch_norms`` a BatchNorm is, in eval, the deploy-time
``x * w + b`` in its input's dtype (the JAX package's
``folded_inference_bn``).
"""
from __future__ import annotations

import contextlib
from typing import Any, Iterator, Sequence

import torch
import torch.nn.functional as F
from torch import nn


def promoted(*tensors: torch.Tensor | None) -> list[torch.Tensor | None]:
    """``tensors`` in the promotion of their dtypes, as flax's layers
    compute (None passes through; a tensor of that dtype already is not
    touched)."""
    dt = tensors[0].dtype
    for t in tensors[1:]:
        if t is not None:
            dt = torch.promote_types(dt, t.dtype)
    return [t if t is None or t.dtype == dt else t.to(dt) for t in tensors]


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in ``promote_types(input, weight, bias)``, as
    flax's ``nn.Conv`` does (``F.conv2d`` refuses mixed dtypes). The same
    parameters and state_dict keys as ``nn.Conv2d``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(*promoted(x, self.weight, self.bias))


def same_padding(size: int, kernel: int, stride: int = 1) -> tuple[int, int]:
    """lax's ``"SAME"`` padding of one axis: ``ceil(size / stride)`` outputs,
    the total padding that needs split with the smaller half before (an
    even kernel at stride 1 pads ``(k-1)//2`` before and ``k//2`` after)."""
    total = max((-(-size // stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class SameConv2d(Conv2d):
    """``Conv2d`` with flax's ``padding="SAME"`` at any kernel and stride:
    the padding of ``same_padding``, which is uneven for an even kernel or
    a stride that does not divide the input, applied with ``F.pad`` before
    a convolution with ``padding=0``. The same parameters and state_dict
    keys as ``nn.Conv2d``."""

    def __init__(self, in_ch: int, out_ch: int, kernel, stride=1,
                 bias: bool = True):
        super().__init__(in_ch, out_ch, kernel, stride, padding=0, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (kh, kw), (sh, sw) = self.kernel_size, self.stride
        top, bottom = same_padding(x.shape[-2], kh, sh)
        left, right = same_padding(x.shape[-1], kw, sw)
        if top or bottom or left or right:
            x = F.pad(x, (left, right, top, bottom))
        return super().forward(x)


class Linear(nn.Linear):
    """``nn.Linear`` computing in ``promote_types(input, weight, bias)``, as
    flax's ``nn.Dense`` does."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(*promoted(x, self.weight, self.bias))


class BatchNorm(nn.Module):
    """The JAX package's ``batch_norm`` (flax ``nn.BatchNorm``) over dim 1.

    eval: ``(x - running_mean) / sqrt(running_var + eps) * weight + bias``,
    in f32, cast back to the input's dtype; once ``fold_batch_norms`` has
    set ``folded`` (the JAX package's ``FoldedBatchNorm``), ``x * w + b``
    in the input's dtype (one ``addcmul``) from the (w, b) it kept in that
    dtype. The state_dict is the same either way, so one checkpoint drives
    both.
    train: normalises with the batch's statistics over every dim but 1,
    computed as flax computes them (``use_fast_variance``): f32
    ``E[x]`` and the biased ``E[x^2] - E[x]^2`` clipped at 0, then
    ``(x - mean) * (rsqrt(var + eps) * weight) + bias``; the gradient flows
    through the mean and the variance. The running statistics are not
    written in the forward: ``momentum * old + (1 - momentum) * batch``
    (flax's momentum, with the biased variance) is staged, and
    ``commit_batch_stats`` writes it after the loss and its backward, so
    that an eval-form call in between (the IRL penalty's reward net) still
    sees the pre-step statistics, as flax's ``mutable=["batch_stats"]``
    gives. A second train-mode call before the commit stages on top of the
    first, as a second flax call in one ``apply`` does.

    eps 1e-5 and momentum 0.9 are flax's defaults; the EfficientNet trunk
    passes 1e-3 and 0.99.
    """

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.9):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.folded = False
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.staged: tuple[torch.Tensor, torch.Tensor] | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training and self.folded:
            shape = (1, -1) + (1,) * (x.dim() - 2)
            name = _dtype_name(x.dtype)
            w, b = getattr(self, f"fold_w_{name}"), getattr(self,
                                                            f"fold_b_{name}")
            return torch.addcmul(b.view(shape), x, w.view(shape))
        if not self.training:
            return F.batch_norm(x.float(), self.running_mean,
                                self.running_var, self.weight, self.bias,
                                False, 0.0, self.eps).to(x.dtype)
        xf = x.float()
        dims = [0, *range(2, x.dim())]
        mean = xf.mean(dims)
        var = torch.clamp((xf * xf).mean(dims) - mean * mean, min=0.0)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        with torch.no_grad():
            old = self.staged or (self.running_mean, self.running_var)
            m = self.momentum
            self.staged = (m * old[0] + (1 - m) * mean,
                           m * old[1] + (1 - m) * var)
        return y.to(x.dtype)


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm(num_groups)`` over dim 1 (its ``scale`` is
    ``weight``): per sample and group of ``C / num_groups`` channels, the
    mean and the biased ``E[x^2] - E[x]^2`` clipped at 0 over the group's
    channels and every spatial position (flax's ``use_fast_variance``), in
    at least f32, then ``(x - mean) * (rsqrt(var + eps) * weight) + bias``,
    returned in the promotion of the input's and the weights' dtypes, as
    flax returns it. ``eps`` 1e-6 is flax's default (torch's
    ``nn.GroupNorm`` has 1e-5). No running statistics: train and eval are
    one computation."""

    def __init__(self, num_groups: int, num_features: int,
                 eps: float = 1e-6):
        super().__init__()
        if num_features % num_groups:
            raise ValueError(f"Number of groups ({num_groups}) does not "
                             f"divide the number of channels "
                             f"({num_features}).")
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C = x.shape[:2]
        G = self.num_groups
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        g = xf.reshape(B, G, -1)
        mean = g.mean(-1)
        var = torch.clamp((g * g).mean(-1) - mean * mean, min=0.0)
        shape = (B, C) + (1,) * (x.dim() - 2)
        mean = mean.repeat_interleave(C // G, 1).view(shape)
        var = var.repeat_interleave(C // G, 1).view(shape)
        pshape = (1, C) + (1,) * (x.dim() - 2)
        mul = torch.rsqrt(var + self.eps) * self.weight.view(pshape)
        y = (xf - mean) * mul + self.bias.view(pshape)
        return y.to(torch.promote_types(x.dtype, self.weight.dtype))


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def fold_batch_norms(module: nn.Module,
                     dtype: torch.dtype = torch.float32) -> nn.Module:
    """Switches every BatchNorm in ``module`` to its folded eval form
    (``BatchNorm``'s ``folded``): ``w = weight * rsqrt(running_var + eps)``
    and ``b = bias - running_mean * w``, computed now in f32 from the
    loaded statistics (fold after loading the weights), are kept as the
    non-persistent buffers ``fold_w_<dtype>``, ``fold_b_<dtype>`` in each
    dtype a BatchNorm can read: f32 (the f32 islands of a bf16 graph) and
    ``dtype``, the stream's. Training mode is unaffected. Returns
    ``module``."""
    for m in module.modules():
        if isinstance(m, BatchNorm):
            with torch.no_grad():
                w = m.weight.float() * torch.rsqrt(m.running_var.float()
                                                   + m.eps)
                b = m.bias.float() - m.running_mean.float() * w
            for dt in dict.fromkeys((torch.float32, dtype)):
                name = _dtype_name(dt)
                m.register_buffer(f"fold_w_{name}", w.to(dt),
                                  persistent=False)
                m.register_buffer(f"fold_b_{name}", b.to(dt),
                                  persistent=False)
            m.folded = True
    return module


@torch.no_grad()
def commit_batch_stats(module: nn.Module) -> None:
    """Write every BatchNorm's staged running statistics (see
    ``BatchNorm``) into its buffers."""
    for m in module.modules():
        if isinstance(m, BatchNorm) and m.staged is not None:
            m.running_mean.copy_(m.staged[0])
            m.running_var.copy_(m.staged[1])
            m.staged = None


def discard_batch_stats(module: nn.Module) -> None:
    """Drop every BatchNorm's staged running statistics."""
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.staged = None


@contextlib.contextmanager
def eval_form(module: nn.Module) -> Iterator[nn.Module]:
    """``module`` in eval mode for the ``with`` block, each submodule's
    mode restored after it."""
    modes = [(m, m.training) for m in module.modules()]
    module.eval()
    try:
        yield module
    finally:
        for m, training in modes:
            m.training = training


class ConvLayer(nn.Module):
    """conv(k, s, pad k//2) [+ BN | GN] [+ ReLU] (reference conv.py:63-85).

    ``norm_type`` "batch_norm" (``BatchNorm_0``) or "group_norm"
    (``GroupNorm_0``, flax's ``nn.GroupNorm(num_groups=2)``); any other
    raises ``ValueError``, as the JAX module does when it is called."""

    def __init__(self, in_ch: int, features: int, kernel: int = 3,
                 stride: int = 1, use_norm: bool = False,
                 norm_type: str = "batch_norm", relu: bool = True,
                 use_bias: bool = False):
        super().__init__()
        self.Conv_0 = Conv2d(in_ch, features, kernel, stride,
                             padding=kernel // 2, bias=use_bias)
        self.norm = None
        if use_norm:
            if norm_type == "batch_norm":
                self.norm, self.BatchNorm_0 = "BatchNorm_0", BatchNorm(features)
            elif norm_type == "group_norm":
                self.norm, self.GroupNorm_0 = "GroupNorm_0", GroupNorm(
                    2, features)
            else:
                raise ValueError(f"Unknown norm type: {norm_type}")
        self.relu = relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Conv_0(x)
        if self.norm is not None:
            x = getattr(self, self.norm)(x)
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
            self.add_module(f"Conv_{i}", Conv2d(
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
            self.add_module(f"Dense_{i}", Linear(in_dim, d))
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


def resize_bilinear_antialiased(x: torch.Tensor,
                                size: Sequence[int]) -> torch.Tensor:
    """Bilinear resize of NCHW ``x`` to ``size`` that equals
    ``jax.image.resize(..., "bilinear")`` in both directions: upsampling
    as ``resize_bilinear``, and downsampling with the triangle kernel
    widened by ``in / out`` and renormalised, which is JAX's antialiasing
    and ``F.interpolate(antialias=True)``'s alike
    (``tests/test_torch_secondary_models.py`` holds it to JAX to 1e-6 at
    scales 0.3 to 2)."""
    return F.interpolate(x, size=tuple(int(s) for s in size),
                         mode="bilinear", align_corners=False, antialias=True)


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
