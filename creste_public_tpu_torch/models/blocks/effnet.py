"""EfficientNet-b0 RGBD trunk + U-Net style decoder (PyTorch, NCHW).

Counterpart of ``creste_public_tpu/models/blocks/effnet.py``. Padding is
load-bearing for weight fidelity: the blocks use static "same" padding
computed for the nominal 224x224 chain, the stem uses the real image size
(for 512x612 that gives the reference's ds4 map of 128x153). The pads are
asymmetric, so they are applied with ``F.pad`` before a ``padding=0`` conv.
EfficientNet BNs use eps 1e-3; decoder BNs the torch default 1e-5.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from creste_public_tpu_torch.models.blocks.convnets import (
    BatchNorm,
    resize_bilinear,
)

# (num_repeat, kernel, stride, expand, in_ch, out_ch) per b0 stage.
B0_STAGES = [
    (1, 3, 1, 1, 32, 16),
    (2, 3, 2, 6, 16, 24),
    (2, 5, 2, 6, 24, 40),
    (3, 3, 2, 6, 40, 80),
    (3, 5, 1, 6, 80, 112),
    (4, 5, 2, 6, 112, 192),
    (1, 3, 1, 6, 192, 320),
]
SE_RATIO = 0.25
_EFF_EPS = 1e-3


def static_same_pad(in_hw: tuple[int, int], k: int, s: int):
    """Asymmetric pad amounts ((top, bottom), (left, right)) of
    Conv2dStaticSamePadding for a nominal input size."""
    ih, iw = in_hw
    oh, ow = math.ceil(ih / s), math.ceil(iw / s)
    pad_h = max((oh - 1) * s + k - ih, 0)
    pad_w = max((ow - 1) * s + k - iw, 0)
    return (
        (pad_h // 2, pad_h - pad_h // 2),
        (pad_w // 2, pad_w - pad_w // 2),
    )


class PaddedConv2d(nn.Conv2d):
    """Bias-free conv with explicit (possibly asymmetric) padding."""

    def __init__(self, cin, cout, k, s, pad, groups=1):
        super().__init__(cin, cout, k, s, padding=0, groups=groups,
                         bias=False)
        (t, b), (l, r) = pad
        self.pad = (l, r, t, b)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if any(self.pad):
            x = F.pad(x, self.pad)
        return super().forward(x)


class MBConvBlock(nn.Module):
    """Mobile inverted bottleneck with squeeze-excitation (b0 semantics,
    inference: no drop-connect)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int,
                 expand: int, nominal_hw: tuple[int, int]):
        super().__init__()
        c = in_ch * expand
        self.expand = expand != 1
        if self.expand:
            self.expand_conv = nn.Conv2d(in_ch, c, 1, bias=False)
            self.bn0 = BatchNorm(c, _EFF_EPS)
        self.depthwise_conv = PaddedConv2d(
            c, c, kernel, stride, static_same_pad(nominal_hw, kernel, stride),
            groups=c)
        self.bn1 = BatchNorm(c, _EFF_EPS)
        n_sq = max(1, int(in_ch * SE_RATIO))
        self.se_reduce = nn.Conv2d(c, n_sq, 1)
        self.se_expand = nn.Conv2d(n_sq, c, 1)
        self.project_conv = nn.Conv2d(c, out_ch, 1, bias=False)
        self.bn2 = BatchNorm(out_ch, _EFF_EPS)
        self.residual = stride == 1 and in_ch == out_ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inp = x
        if self.expand:
            x = F.silu(self.bn0(self.expand_conv(x)))
        x = F.silu(self.bn1(self.depthwise_conv(x)))
        se = x.mean(dim=(2, 3), keepdim=True)
        se = self.se_expand(F.silu(self.se_reduce(se)))
        x = torch.sigmoid(se) * x
        x = self.bn2(self.project_conv(x))
        if self.residual:
            x = x + inp
        return x


class EfficientNetB0Trunk(nn.Module):
    """Stem + MBConv blocks; returns the endpoint pyramid.

    Endpoints follow efficientnet_pytorch.extract_endpoints: the tensor
    before each spatial reduction, plus the final block output, giving
    reduction_1..5 with channels (16, 24, 40, 112, 320).
    """

    def __init__(self, in_channels: int = 4,
                 image_size: Sequence[int] = (512, 612),
                 stage_repeats: int | None = None):
        super().__init__()
        self.conv_stem = PaddedConv2d(
            in_channels, 32, 3, 2, static_same_pad(tuple(image_size), 3, 2))
        self.bn0 = BatchNorm(32, _EFF_EPS)
        nominal = (112, 112)
        self.n_blocks = 0
        for (rep, k, s, e, cin, cout) in B0_STAGES:
            if stage_repeats is not None:
                rep = min(rep, stage_repeats)
            for r in range(rep):
                stride = s if r == 0 else 1
                self.add_module(f"block_{self.n_blocks}", MBConvBlock(
                    cin if r == 0 else cout, cout, k, stride, e, nominal))
                self.n_blocks += 1
                nominal = (math.ceil(nominal[0] / stride),
                           math.ceil(nominal[1] / stride))

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        x = F.silu(self.bn0(self.conv_stem(x)))
        endpoints: dict[str, torch.Tensor] = {}
        prev = x
        for idx in range(self.n_blocks):
            x = getattr(self, f"block_{idx}")(x)
            if prev.shape[2] > x.shape[2]:
                endpoints[f"reduction_{len(endpoints) + 1}"] = prev
            elif idx == self.n_blocks - 1:
                endpoints[f"reduction_{len(endpoints) + 1}"] = x
            prev = x
        return endpoints


class Up(nn.Module):
    """Bilinear-resize x1 to x2's size, concat [x2, x1], 2x (conv3x3 + BN +
    ReLU) (reference effnet.py:8-28)."""

    def __init__(self, in_ch: int, features: int):
        super().__init__()
        self.conv_0 = nn.Conv2d(in_ch, features, 3, padding=1, bias=False)
        self.bn_0 = BatchNorm(features)
        self.conv_1 = nn.Conv2d(features, features, 3, padding=1, bias=False)
        self.bn_1 = BatchNorm(features)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        x1 = resize_bilinear(x1, x2.shape[-2:])
        x = torch.cat([x2, x1], dim=1)
        x = F.relu(self.bn_0(self.conv_0(x)))
        return F.relu(self.bn_1(self.conv_1(x)))


class EffNet(nn.Module):
    """EfficientNet-b0 trunk + Up decoder to ``downsample`` (reference
    effnet.py:31-98). Returns (y, x): the projected ``out_channels`` map and
    the pre-projection decoder tensor."""

    def __init__(self, in_channels: int = 4, out_channels: int = 256,
                 image_size: Sequence[int] = (512, 612), downsample: int = 4,
                 stage_repeats: int | None = None):
        super().__init__()
        self.trunk = EfficientNetB0Trunk(in_channels, image_size,
                                         stage_repeats)
        channels = [320, 112, 40, 24, 16, in_channels]
        scale = 32 // downsample
        self.n_up = 0
        C = channels[0]
        while scale > 1:
            scale //= 2
            self.n_up += 1
            C += channels[self.n_up]
            self.add_module(f"up{self.n_up}", Up(C, C))
        self.conv = nn.Conv2d(C, out_channels, 1)

    def forward(self, x: torch.Tensor):
        endpoints = self.trunk(x)
        endpoints["reduction_0"] = x
        y = endpoints["reduction_5"]
        for i in range(1, self.n_up + 1):
            y = getattr(self, f"up{i}")(y, endpoints[f"reduction_{5 - i}"])
        return self.conv(y), y
