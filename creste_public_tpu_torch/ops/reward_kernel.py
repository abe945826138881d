"""Inference-mode MultiScaleFCN reward head with every BN folded, on a
hand-written CUDA kernel.

Counterpart of ``creste_public_tpu/ops/reward_pallas.py``. At inference each
BatchNorm is a per-channel ``a * x + b``, so every layer of the head is one
conv + affine (+ the trunk's relu before its BN, + relu after). On CUDA
tensors each layer is one launch of ``csrc/msfcn_chain.cu`` (seven per
head at the production config); the 2x2 maxpool, the bilinear x2 upsample
and the concat between the chains stay PyTorch ops, as they were XLA ops
outside the Pallas kernels. On CPU tensors the same function runs its plain
PyTorch version. Inference only: no backward.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable

import torch
import torch.nn.functional as F

from creste_public_tpu_torch.models.blocks.convnets import (
    MultiScaleFCN,
    resize_bilinear,
)
from creste_public_tpu_torch.ops import _build

Layer = dict  # {"kernel" [kh,kw,Ci,Co], "a" [Co], "b" [Co], "pre_relu", "post_relu"}


def _fold(conv: torch.nn.Conv2d, bn, pre_relu: bool) -> Layer:
    w = conv.weight.detach().float()
    a = bn.weight.detach().float() / torch.sqrt(
        bn.running_var.detach().float() + bn.eps)
    b = bn.bias.detach().float() - bn.running_mean.detach().float() * a
    return {
        "kernel": w.permute(2, 3, 1, 0).contiguous(),  # OIHW -> HWIO
        "a": a.contiguous(),
        "b": b.contiguous(),
        "pre_relu": pre_relu,
        "post_relu": True,
    }


def fold_msfcn_params(msfcn: MultiScaleFCN) -> dict[str, list[Layer]]:
    """Fold a MultiScaleFCN into per-layer (kernel, a, b) with
    ``a = scale / sqrt(var + eps)`` and ``b = bias - mean * a``.
    prepool_i / skip_i / postpool_i are conv -> BN -> relu; trunk_i is
    conv -> relu then trunk_bn_i -> relu, kept as ``pre_relu``."""

    def stack(name, n):
        return [_fold(getattr(msfcn, f"{name}_{i}").Conv_0,
                      getattr(msfcn, f"{name}_{i}").BatchNorm_0, False)
                for i in range(n)]

    if not msfcn.trunk_bn:
        raise NotImplementedError("MultiScaleFCN trunk without BN")
    return {
        "prepool": stack("prepool", msfcn.n_prepool),
        "skip": stack("skip", msfcn.n_skip),
        "trunk": [_fold(getattr(msfcn, f"trunk_{i}").Conv_0,
                        getattr(msfcn, f"trunk_bn_{i}"), True)
                  for i in range(msfcn.n_trunk)],
        "postpool": stack("postpool", msfcn.n_postpool),
    }


def conv_affine_plain(x: torch.Tensor, layer: Layer) -> torch.Tensor:
    """Plain PyTorch version of one folded layer: NHWC in, NHWC out."""
    kh, kw = layer["kernel"].shape[:2]
    y = F.conv2d(x.permute(0, 3, 1, 2), layer["kernel"].permute(3, 2, 0, 1),
                 padding=(kh // 2, kw // 2))
    if layer["pre_relu"]:
        y = F.relu(y)
    y = y * layer["a"][:, None, None] + layer["b"][:, None, None]
    if layer["post_relu"]:
        y = F.relu(y)
    return y.permute(0, 2, 3, 1)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("msfcn_chain")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.msfcn_conv_affine.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i,
                                      i, p]
    lib.msfcn_conv_affine.restype = ctypes.c_int
    lib.msfcn_error_string.argtypes = [ctypes.c_int]
    lib.msfcn_error_string.restype = ctypes.c_char_p
    return lib


def conv_affine_cuda(x: torch.Tensor, layer: Layer) -> torch.Tensor:
    """One folded layer as one launch of the CUDA kernel.

    Takes contiguous NHWC f32 CUDA tensors and an odd kernel size; raises on
    anything else and on a launch error. Adds one to
    ``conv_affine_cuda.launches`` for each launch."""
    w, a, b = layer["kernel"], layer["a"], layer["b"]
    for name, t in (("x", x), ("kernel", w), ("a", a), ("b", b)):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{name} must lie on x's CUDA device, got "
                             f"{t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"x must be [B,H,W,C] and kernel [kh,kw,Ci,Co], "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    B, H, W, Ci = x.shape
    kh, kw, wci, Co = w.shape
    if wci != Ci or a.shape != (Co,) or b.shape != (Co,):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, kernel "
                         f"{tuple(w.shape)}, a {tuple(a.shape)}, "
                         f"b {tuple(b.shape)}")
    if kh % 2 == 0 or kw % 2 == 0:
        raise ValueError(f"kernel size must be odd, got {kh}x{kw}")
    if B * H * W * max(Co, Ci) >= 2**31:
        raise ValueError(f"tensor too large for the kernel: {tuple(x.shape)}")
    y = torch.empty((B, H, W, Co), dtype=torch.float32, device=x.device)
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.msfcn_conv_affine(
        x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(), y.data_ptr(),
        B, H, W, Ci, Co, kh, kw, int(layer["pre_relu"]),
        int(layer["post_relu"]), stream)
    if err:
        raise RuntimeError(
            f"msfcn_conv_affine launch failed: "
            f"{lib.msfcn_error_string(err).decode()}")
    conv_affine_cuda.launches += 1
    return y


conv_affine_cuda.launches = 0


def conv_affine(x: torch.Tensor, layer: Layer) -> torch.Tensor:
    """One folded layer: the plain version for a CPU tensor, the CUDA
    kernel for a CUDA tensor."""
    if x.device.type == "cpu":
        return conv_affine_plain(x, layer)
    return conv_affine_cuda(x, layer)


def msfcn_chain(folded: dict[str, list[Layer]], x: torch.Tensor,
           conv: Callable[[torch.Tensor, Layer], torch.Tensor]
           ) -> torch.Tensor:
    """The folded head with ``conv`` computing each layer (NHWC)."""
    x = x.float().contiguous()
    H, W = x.shape[1:3]

    def run(layers, t):
        for ly in layers:
            t = conv(t.contiguous(), ly)
        return t

    # K1: prepool, forking the skip branch off its output
    p_out = run(folded["prepool"], x)
    s_out = run(folded["skip"], p_out)
    # 2x2 maxpool, then K2: the trunk at half resolution
    t = F.max_pool2d(p_out.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
    t = run(folded["trunk"], t)
    # bilinear x2 upsample + concat, then K3: the postpool
    t = resize_bilinear(t.permute(0, 3, 1, 2), (H, W)).permute(0, 2, 3, 1)
    return run(folded["postpool"], torch.cat([t, s_out], dim=-1))


def msfcn_fused_apply(folded: dict[str, list[Layer]],
                      x: torch.Tensor) -> torch.Tensor:
    """Folded inference MultiScaleFCN: x [B, H, W, C] -> [B, H, W, 1] NHWC.
    ``folded`` comes from ``fold_msfcn_params``. CUDA tensors go through the
    kernel, CPU tensors through the plain version."""
    return msfcn_chain(folded, x, conv_affine)


def msfcn_plain(folded: dict[str, list[Layer]],
                x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the whole folded head, on any device;
    the reference the kernel is held against."""
    return msfcn_chain(folded, x, conv_affine_plain)
