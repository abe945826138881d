"""MSNet2D-style stereo depth network (PyTorch; NHWC at its interface).

Counterpart of ``creste_public_tpu/models/stereodepth.py`` (reference
creste/models/stereodepth.py:56-269 and blocks/stereo_submodule.py,
MobileStereoNet-2D): shared EfficientNet features over the stereo pair, a
group-wise correlation volume at feature resolution (``gwc_volume``), a
2-D hourglass trunk over the disparity-as-channels volume, and a depth
head giving bin logits and their metric depth. Submodules carry the flax
names (``vision_backbone``, ``hourglass_trunk`` with ``preconv``,
``dres0a`` ... ``classif_b`` and ``hg1``-``hg3``, ``depth_head``).

flax's ``padding="SAME"`` is lax's: a stride-2 convolution on an even
size pads one row after and none before (``convnets.SameConv2d``), and a
stride-2 ``nn.ConvTranspose`` dilates its input and pads ``(2, 1)`` at
kernel 3 without flipping its kernel (``ConvTranspose``).
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from creste_public_tpu_torch.models.blocks.convnets import (
    BatchNorm,
    MultiLayerConv,
    SameConv2d,
)
from creste_public_tpu_torch.models.depth_completion import VisionEncoder
from creste_public_tpu_torch.utils import depth as du


def gwc_volume(left: torch.Tensor, right: torch.Tensor, max_disp: int,
               num_groups: int) -> torch.Tensor:
    """Group-wise correlation volume.

    left/right: [B, H, W, C] -> [B, H, W, D*G] (disparity-major channels).
    Disparity d compares left[:, :, x] with right[:, :, x-d]; out-of-frame
    columns are zero (stereo_submodule.py:244-263 semantics, NHWC).
    """
    B, H, W, C = left.shape
    g = num_groups
    slabs = []
    for d in range(max_disp):
        if d == 0:
            prod = left * right
        else:
            shifted = F.pad(right, (0, 0, d, 0))[:, :, :W]
            mask = (torch.arange(W, device=left.device) >= d).to(
                left.dtype)[None, None, :, None]
            prod = left * shifted * mask
        slabs.append(prod.reshape(B, H, W, g, C // g).mean(-1))
    return torch.cat(slabs, dim=-1)


def conv_transpose_padding(kernel: int, stride: int) -> tuple[int, int]:
    """lax.conv_transpose's ``"SAME"`` padding of the dilated input."""
    pad_len = kernel + stride - 2
    pad_a = kernel - 1 if stride > kernel - 1 else -(-pad_len // 2)
    return pad_a, pad_len - pad_a


class ConvTranspose(nn.Module):
    """flax ``nn.ConvTranspose(features, (k, k), strides=(s, s),
    padding="SAME", use_bias=False)``: the input dilated by ``s`` (zeros
    between its samples), padded as ``conv_transpose_padding``, then a
    correlation with the kernel as stored (flax does not flip it; its
    HWIO kernel maps to ``weight`` [out, in, k, k] like a conv's). Output
    ``s`` times the input's size."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3,
                 stride: int = 2):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel,
                                               kernel))
        nn.init.kaiming_uniform_(self.weight, a=5 ** 0.5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        s, k = self.stride, self.weight.shape[-1]
        up = x.new_zeros(B, C, (H - 1) * s + 1, (W - 1) * s + 1)
        up[:, :, ::s, ::s] = x
        a, b = conv_transpose_padding(k, s)
        return F.conv2d(F.pad(up, (a, b, a, b)), self.weight.to(x.dtype))


class ConvBnRelu(nn.Module):
    def __init__(self, in_ch: int, ch: int, kernel: int = 3,
                 stride: int = 1):
        super().__init__()
        self.Conv_0 = SameConv2d(in_ch, ch, kernel, stride, bias=False)
        self.BatchNorm_0 = BatchNorm(ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.BatchNorm_0(self.Conv_0(x)))


class Hourglass2D(nn.Module):
    """Down2-down2-up2-up2 encoder/decoder with skip connections
    (stereo_submodule.py:177 hourglass2D equivalent)."""

    def __init__(self, in_ch: int, ch: int):
        super().__init__()
        self.down1 = ConvBnRelu(in_ch, ch * 2, stride=2)
        self.down2 = ConvBnRelu(ch * 2, ch * 2, stride=2)
        self.up1 = ConvTranspose(ch * 2, ch * 2)
        self.up1_bn = BatchNorm(ch * 2)
        self.up2 = ConvTranspose(ch * 2, ch)
        self.up2_bn = BatchNorm(ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d1 = self.down1(x)
        d2 = self.down2(d1)
        u1 = F.relu(self.up1_bn(self.up1(d2)) + d1)
        return F.relu(self.up2_bn(self.up2(u1)) + x)


class HourGlassTrunk(nn.Module):
    """Cost-volume trunk: 1x1 channel squeeze, GWC volume, residual base,
    3 stacked hourglasses, classifier (stereodepth.py:56-160)."""

    def __init__(self, cfg: Any, in_ch: int):
        super().__init__()
        squeeze = int(cfg.get("squeeze_dim", 64))
        self.groups = int(cfg.get("num_groups", 1))
        self.vol = int(cfg.get("volume_size", 48))
        hg = int(cfg.get("hg_size", self.vol * self.groups))
        self.preconv = SameConv2d(in_ch, squeeze, 1)
        self.dres0a = ConvBnRelu(self.vol * self.groups, hg)
        self.dres0b = ConvBnRelu(hg, hg)
        self.dres1a = ConvBnRelu(hg, hg)
        self.dres1b = SameConv2d(hg, hg, 3, bias=False)
        self.hg1 = Hourglass2D(hg, hg)
        self.hg2 = Hourglass2D(hg, hg)
        self.hg3 = Hourglass2D(hg, hg)
        self.classif_a = ConvBnRelu(hg, hg)
        self.classif_b = SameConv2d(hg, hg, 3, bias=False)

    def forward(self, left: torch.Tensor, right: torch.Tensor
                ) -> torch.Tensor:
        """NCHW features of each view -> the NCHW cost features."""
        B = left.shape[0]
        pre = self.preconv(torch.cat([left, right], 0)).permute(0, 2, 3, 1)
        volume = gwc_volume(pre[:B], pre[B:], self.vol, self.groups)
        cost = self.dres0b(self.dres0a(volume.permute(0, 3, 1, 2)))
        cost = cost + self.dres1b(self.dres1a(cost))
        out = self.hg3(self.hg2(self.hg1(cost)))
        return self.classif_b(self.classif_a(out))


class MSNet2D(nn.Module):
    """Stereo pair -> depth-bin logits + metric depth
    (stereodepth.py:168-269)."""

    def __init__(self, cfg: Any):
        super().__init__()
        self.cfg = cfg
        self.vision_backbone = VisionEncoder(cfg["vision_backbone"])
        feat_ch = int(cfg["vision_backbone"]["effnet_cfgs"]["out_channels"])
        self.hourglass_trunk = HourGlassTrunk(cfg["costvolume_trunk"],
                                              feat_ch)
        self.depth_head = MultiLayerConv(cfg["depth_head"])

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        """x: [B, 2, H, W, 3] stereo pairs (left = view 0)."""
        B, N, H, W, C = x.shape
        if N != 2:
            raise ValueError("Stereo depth network requires 2 cameras")
        feats = self.vision_backbone(
            x.reshape(B * N, H, W, C).permute(0, 3, 1, 2).contiguous())
        cost = self.hourglass_trunk(feats[0::2], feats[1::2])
        logits = self.depth_head(cost).permute(0, 2, 3, 1)
        disc = self.cfg["discretize"]
        metric_mm = du.metric_depth_from_logits(
            logits, disc["mode"], float(disc["depth_min"]),
            float(disc["depth_max"]), int(disc["num_bins"]))
        out = {
            "depth_preds_logits": logits,
            "depth_preds_metric": metric_mm / 1000.0,
            "depth_preds_bins": logits.argmax(dim=-1).to(torch.int32),
        }
        if self.cfg["vision_backbone"].get("return_feats", True):
            out["depth_preds_feats"] = feats[0::2].permute(0, 2, 3, 1)
        return out
