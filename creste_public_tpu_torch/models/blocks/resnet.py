"""ResNet18 basic blocks + BEV inpainting multi-head decoder (NCHW inside).

Counterpart of ``creste_public_tpu/models/blocks/resnet.py`` (reference
inpainting.py:9-109): a 7x7/s2 stem, resnet18 layers 1-3 (no maxpool) and
one DeconvHead per task. The retired ``merged_heads`` variant is not
ported.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from creste_public_tpu_torch.models.blocks.convnets import (
    BatchNorm,
    resize_bilinear,
)
from creste_public_tpu_torch.models.blocks.effnet import Up


class BasicBlock(nn.Module):
    """torchvision BasicBlock."""

    def __init__(self, in_ch: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_ch, features, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm(features)
        self.conv2 = nn.Conv2d(features, features, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm(features)
        self.down = stride != 1 or in_ch != features
        if self.down:
            self.down_conv = nn.Conv2d(in_ch, features, 1, stride,
                                       bias=False)
            self.down_bn = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = self.down_bn(self.down_conv(x)) if self.down else x
        return F.relu(out + identity)


class DeconvHead(nn.Module):
    """Up(x1 vs skip x2) -> bilinear x2 + conv/BN/ReLU -> 1x1 projection
    (reference inpainting.py:52-68). Returns (preds, features)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.up1 = Up(in_ch, 256)
        self.up2_conv = nn.Conv2d(256, 128, 3, padding=1, bias=False)
        self.up2_bn = BatchNorm(128)
        self.proj = nn.Conv2d(128, out_ch, 1)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor):
        x = self.up1(x1, x2)
        H, W = x.shape[-2:]
        x = resize_bilinear(x, (H * 2, W * 2))
        x = F.relu(self.up2_bn(self.up2_conv(x)))
        return self.proj(x), x


class InpaintingResNet18MultiHead(nn.Module):
    """BEV decoder: 7x7/s2 stem -> resnet18 layers 1-3 -> N DeconvHeads.
    Reads ``tensor_dict[input_key]`` (NHWC) and returns NHWC
    ``{prefix}_preds`` and ``{prefix}_features`` per head."""

    def __init__(self, num_input_features: int, num_classes: Sequence[int],
                 output_prefix: Sequence[str],
                 input_key: str = "bev_features"):
        super().__init__()
        self.input_key = input_key
        self.output_prefix = list(output_prefix)
        self.conv1 = nn.Conv2d(num_input_features, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm(64)
        self.layer1_0 = BasicBlock(64, 64)
        self.layer1_1 = BasicBlock(64, 64)
        self.layer2_0 = BasicBlock(64, 128, 2)
        self.layer2_1 = BasicBlock(128, 128)
        self.layer3_0 = BasicBlock(128, 256, 2)
        self.layer3_1 = BasicBlock(256, 256)
        for i, n in enumerate(num_classes):
            self.add_module(f"head_{i}", DeconvHead(256 + 64, int(n)))

    def forward(self, tensor_dict: dict[str, torch.Tensor]
                ) -> dict[str, torch.Tensor]:
        x = tensor_dict[self.input_key].permute(0, 3, 1, 2).contiguous()
        x = F.relu(self.bn1(self.conv1(x)))
        x = self.layer1_1(self.layer1_0(x))
        x1 = x
        x = self.layer2_1(self.layer2_0(x))
        x = self.layer3_1(self.layer3_0(x))
        out: dict[str, torch.Tensor] = {}
        for i, prefix in enumerate(self.output_prefix):
            preds, fea = getattr(self, f"head_{i}")(x, x1)
            out[f"{prefix}_preds"] = preds.permute(0, 2, 3, 1)
            out[f"{prefix}_features"] = fea.permute(0, 2, 3, 1)
        return out
