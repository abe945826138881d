"""FoundationBackbone: ViT encoder + depth head (ablation backbone).

Counterpart of ``creste_public_tpu/models/foundation.py`` (reference
creste/models/foundation.py:17-155): a DINOv2 ViT extracts patch features
from the ImageNet-normalised RGB channels, resized to
``backbone_cfgs.input_shape``; the features are resized to
``output_shape`` and a MultiLayerConv depth head predicts depth-bin logits
and their metric depth. Both resizes are ``jax.image.resize``'s bilinear,
antialiased when they downsample (``resize_bilinear_antialiased``).
Freezing the ViT is an optimizer-mask concern, not a module concern.
"""
from __future__ import annotations

from typing import Any

import torch
from torch import nn

from creste_public_tpu_torch.models.blocks.convnets import (
    MultiLayerConv,
    resize_bilinear_antialiased,
)
from creste_public_tpu_torch.models.blocks.vit import (
    VisionTransformer,
    imagenet_normalize,
)
from creste_public_tpu_torch.utils import depth as du


class FoundationBackbone(nn.Module):
    def __init__(self, cfg: Any):
        super().__init__()
        self.cfg = cfg
        bcfg = cfg["vision_backbone"].get("backbone_cfgs", {})
        self.bcfg = bcfg
        self.vit = VisionTransformer(bcfg.get("vit", {}))
        self.depth_head = MultiLayerConv(cfg["depth_head"])

    def forward(self, rgbd: torch.Tensor, p2p: torch.Tensor | None = None
                ) -> dict[str, torch.Tensor]:
        """[B, V, H, W, >=3] frames -> depth_* outputs over B*V frames
        (RGB channels only; ``p2p`` is not read)."""
        B, V, H, W, C = rgbd.shape
        x = rgbd.reshape(B * V, H, W, C)[..., :3]
        in_hw = tuple(self.bcfg.get("input_shape", (H, W)))
        out_hw = tuple(self.bcfg.get("output_shape", (H // 4, W // 4)))
        if (H, W) != in_hw:
            x = resize_bilinear_antialiased(
                x.permute(0, 3, 1, 2), in_hw).permute(0, 2, 3, 1)
        feats = self.vit(imagenet_normalize(x))
        feats = resize_bilinear_antialiased(feats.permute(0, 3, 1, 2),
                                            out_hw)
        logits = self.depth_head(feats).permute(0, 2, 3, 1)
        disc = self.cfg["discretize"]
        metric_mm = du.metric_depth_from_logits(
            logits, disc["mode"], float(disc["depth_min"]),
            float(disc["depth_max"]), int(disc["num_bins"]))
        return {
            "depth_preds_feats": feats.permute(0, 2, 3, 1),
            "depth_preds_logits": logits,
            "depth_preds_metric": metric_mm / 1000.0,
            "depth_preds_bins": logits.argmax(dim=-1).to(torch.int32),
        }
