"""ResNet18 basic blocks + BEV inpainting multi-head decoder (NCHW inside).

Counterpart of ``creste_public_tpu/models/blocks/resnet.py`` (reference
inpainting.py:9-109): a 7x7/s2 stem, resnet18 layers 1-3 (no maxpool) and
one DeconvHead per task, or with ``merged_heads`` (inference only) the N
heads as one block-diagonal conv chain (``merge_decoder_heads`` rewrites a
per-head state dict into it), and with ``learnable_loss_weight`` a
zero-initialised ``log_var`` parameter that the losses read as
``outputs/log_variance``.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from creste_public_tpu_torch.models.blocks.convnets import (
    BatchNorm,
    Conv2d,
    resize_bilinear,
)
from creste_public_tpu_torch.models.blocks.effnet import Up


class BasicBlock(nn.Module):
    """torchvision BasicBlock."""

    def __init__(self, in_ch: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv2d(in_ch, features, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm(features)
        self.conv2 = Conv2d(features, features, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm(features)
        self.down = stride != 1 or in_ch != features
        if self.down:
            self.down_conv = Conv2d(in_ch, features, 1, stride,
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
        self.up2_conv = Conv2d(256, 128, 3, padding=1, bias=False)
        self.up2_bn = BatchNorm(128)
        self.proj = Conv2d(128, out_ch, 1)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor):
        x = self.up1(x1, x2)
        H, W = x.shape[-2:]
        x = resize_bilinear(x, (H * 2, W * 2))
        x = F.relu(self.up2_bn(self.up2_conv(x)))
        return self.proj(x), x


class InpaintingResNet18MultiHead(nn.Module):
    """BEV decoder: 7x7/s2 stem -> resnet18 layers 1-3 -> N DeconvHeads.
    Reads ``tensor_dict[input_key + key_suffix]`` (NHWC) and returns NHWC
    ``{prefix}_preds`` and ``{prefix}_features`` per head; only the
    ``inpainting_sam`` prefix takes the suffix, so a second call with
    ``key_suffix="_mv"`` (the movability double-forward) writes the other
    heads' keys again, as the JAX decoder does.

    ``merged_heads`` runs the heads as one chain: the first Up conv of
    every head sees the same input, so their filters concatenate on the
    output channels (``mh_conv0``); the later convs are grouped convs with
    one group per head (``mh_conv1``, ``mh_up2``); the 1x1 projections are
    one block-diagonal conv (``mh_proj``). One bilinear resize and one conv
    per layer instead of N; inference only."""

    def __init__(self, num_input_features: int, num_classes: Sequence[int],
                 output_prefix: Sequence[str],
                 input_key: str = "bev_features",
                 learnable_loss_weight: bool = False,
                 merged_heads: bool = False):
        super().__init__()
        self.input_key = input_key
        self.num_classes = [int(n) for n in num_classes]
        self.output_prefix = list(output_prefix)
        self.merged_heads = merged_heads
        self.conv1 = Conv2d(num_input_features, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm(64)
        self.layer1_0 = BasicBlock(64, 64)
        self.layer1_1 = BasicBlock(64, 64)
        self.layer2_0 = BasicBlock(64, 128, 2)
        self.layer2_1 = BasicBlock(128, 128)
        self.layer3_0 = BasicBlock(128, 256, 2)
        self.layer3_1 = BasicBlock(256, 256)
        n = len(self.num_classes)
        if merged_heads:
            self.mh_conv0 = Conv2d(256 + 64, 256 * n, 3, padding=1,
                                   bias=False)
            self.mh_bn0 = BatchNorm(256 * n)
            self.mh_conv1 = Conv2d(256 * n, 256 * n, 3, padding=1,
                                   groups=n, bias=False)
            self.mh_bn1 = BatchNorm(256 * n)
            self.mh_up2 = Conv2d(256 * n, 128 * n, 3, padding=1, groups=n,
                                 bias=False)
            self.mh_up2_bn = BatchNorm(128 * n)
            self.mh_proj = Conv2d(128 * n, sum(self.num_classes), 1)
        else:
            for i, c in enumerate(self.num_classes):
                self.add_module(f"head_{i}", DeconvHead(256 + 64, c))
        self.log_var = (nn.Parameter(torch.zeros(1))
                        if learnable_loss_weight else None)

    def _merged(self, x: torch.Tensor, x1: torch.Tensor):
        """(preds, features) of every head, from the merged chain."""
        if self.training:
            raise RuntimeError("merged_heads is an inference-only rewrite")
        H, W = x1.shape[-2:]
        y = torch.cat([x1, resize_bilinear(x, (H, W))], dim=1)
        y = F.relu(self.mh_bn0(self.mh_conv0(y)))
        y = F.relu(self.mh_bn1(self.mh_conv1(y)))
        y = resize_bilinear(y, (H * 2, W * 2))
        y = F.relu(self.mh_up2_bn(self.mh_up2(y)))
        preds = self.mh_proj(y)
        offs = np.cumsum([0] + self.num_classes)
        return [(preds[:, offs[i]:offs[i + 1]], y[:, i * 128:(i + 1) * 128])
                for i in range(len(self.num_classes))]

    def forward(self, tensor_dict: dict[str, torch.Tensor],
                key_suffix: str = "") -> dict[str, torch.Tensor]:
        x = tensor_dict[f"{self.input_key}{key_suffix}"]
        x = x.permute(0, 3, 1, 2).contiguous()
        x = F.relu(self.bn1(self.conv1(x)))
        x = self.layer1_1(self.layer1_0(x))
        x1 = x
        x = self.layer2_1(self.layer2_0(x))
        x = self.layer3_1(self.layer3_0(x))
        heads = (self._merged(x, x1) if self.merged_heads else
                 [getattr(self, f"head_{i}")(x, x1)
                  for i in range(len(self.num_classes))])
        out: dict[str, torch.Tensor] = {}
        for prefix, (preds, fea) in zip(self.output_prefix, heads):
            p = (f"{prefix}{key_suffix}" if prefix == "inpainting_sam"
                 else prefix)
            out[f"{p}_preds"] = preds.permute(0, 2, 3, 1)
            out[f"{p}_features"] = fea.permute(0, 2, 3, 1)
        if self.log_var is not None:
            out["log_variance"] = self.log_var
        return out


def merge_decoder_heads(state: dict[str, torch.Tensor],
                        num_classes: Sequence[int], prefix: str = ""
                        ) -> dict[str, torch.Tensor]:
    """A state dict with the decoder at ``prefix`` rewritten from per-head
    ``head_i.*`` tensors into the merged ``mh_*`` ones that
    ``merged_heads=True`` loads (the JAX package's
    ``merge_decoder_head_variables`` / ``merge_heads_in_variables``): the
    heads' conv filters and BatchNorm vectors concatenate on the output
    channels (a grouped conv's weight is [out, in / groups, kh, kw], the
    groups contiguous on out), and the 1x1 projections are placed on a
    block diagonal. Every other key is kept as it is."""
    n = len(num_classes)

    def cat(leaf: str) -> torch.Tensor:
        return torch.cat([state[f"{prefix}head_{i}.{leaf}"]
                          for i in range(n)])

    out = {k: v for k, v in state.items()
           if not k.startswith(f"{prefix}head_")}
    for dst, src in (("mh_conv0", "up1.conv_0"), ("mh_conv1", "up1.conv_1"),
                     ("mh_up2", "up2_conv")):
        out[f"{prefix}{dst}.weight"] = cat(f"{src}.weight")
    for dst, src in (("mh_bn0", "up1.bn_0"), ("mh_bn1", "up1.bn_1"),
                     ("mh_up2_bn", "up2_bn")):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            out[f"{prefix}{dst}.{leaf}"] = cat(f"{src}.{leaf}")
    w0 = state[f"{prefix}head_0.proj.weight"]
    cin = w0.shape[1]
    kern = w0.new_zeros((sum(int(c) for c in num_classes), cin * n, 1, 1))
    off = 0
    for i, c in enumerate(int(c) for c in num_classes):
        kern[off:off + c, i * cin:(i + 1) * cin] = state[
            f"{prefix}head_{i}.proj.weight"]
        off += c
    out[f"{prefix}mh_proj.weight"] = kern
    out[f"{prefix}mh_proj.bias"] = cat("proj.bias")
    return out
