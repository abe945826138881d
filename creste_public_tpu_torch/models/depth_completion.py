"""Depth completion: RGBD -> dense features + per-pixel depth distribution.

Counterpart of ``creste_public_tpu/models/depth_completion.py``. The EffNet
trunk gives ``depth_embed_dim`` features at downsample ``ds``; a
MultiLayerConv head gives per-bin depth logits; the metric depth is the
softmax expectation over the bin values, in metres.
"""
from __future__ import annotations

from typing import Any

import torch
from torch import nn

from creste_public_tpu_torch.models.blocks.convnets import MultiLayerConv
from creste_public_tpu_torch.models.blocks.effnet import EffNet
from creste_public_tpu_torch.utils import depth as du


class VisionEncoder(nn.Module):
    """Encoder selector (reference vision_encoder.py:8-54): NCHW in, the
    projected EffNet features NCHW out."""

    def __init__(self, cfg: Any):
        super().__init__()
        if cfg["name"] != "efficientnet-b0":
            raise NotImplementedError(f"Vision encoder {cfg['name']}")
        eff = cfg["effnet_cfgs"]
        self.effnet = EffNet(
            in_channels=int(eff["in_channels"]),
            out_channels=int(eff["out_channels"]),
            image_size=tuple(eff["image_size"]),
            downsample=int(eff["downsample"]),
            stage_repeats=eff.get("stage_repeats", None),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.effnet(x)[0]


class DepthCompletion(nn.Module):
    """RGBD [B, H, W, C] -> {depth_preds_logits [B, Hs, Ws, D],
    depth_preds_metric [B, Hs, Ws] (metres), depth_preds_bins,
    depth_preds_feats [B, Hs, Ws, Z]}, all NHWC."""

    def __init__(self, cfg: Any):
        super().__init__()
        self.cfg = cfg
        self.vision_backbone = VisionEncoder(cfg["vision_backbone"])
        self.depth_head = MultiLayerConv(cfg["depth_head"])

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        disc = self.cfg["discretize"]
        feats = self.vision_backbone(x.permute(0, 3, 1, 2).contiguous())
        logits = self.depth_head(feats).permute(0, 2, 3, 1)
        metric_mm = du.metric_depth_from_logits(
            logits, disc["mode"], float(disc["depth_min"]),
            float(disc["depth_max"]), int(disc["num_bins"]))
        outputs = {
            "depth_preds_logits": logits,
            "depth_preds_metric": metric_mm / 1000.0,
            "depth_preds_bins": logits.argmax(dim=-1),
        }
        if self.cfg["vision_backbone"].get("return_feats", True):
            outputs["depth_preds_feats"] = feats.permute(0, 2, 3, 1)
        return outputs
