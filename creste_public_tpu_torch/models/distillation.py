"""Distillation backbone: depth completion + DINOv2 feature head.

Counterpart of ``creste_public_tpu/models/distillation.py`` for the branch
the deployment graph runs: no learned positional-encoding map
(``pe_map is None``, distillation.py:86-87). The PE-map and multiview
branches are training-stage features and raise here.
"""
from __future__ import annotations

from typing import Any

import torch
from torch import nn

from creste_public_tpu_torch.models.blocks.convnets import MultiLayerConv
from creste_public_tpu_torch.models.blocks.effnet import DropConnect
from creste_public_tpu_torch.models.depth_completion import DepthCompletion


class DistillationBackbone(nn.Module):
    def __init__(self, cfg: Any):
        super().__init__()
        if cfg.get("pe_map", None) is not None:
            raise NotImplementedError("DistillationBackbone with a pe_map")
        if cfg.get("multiview_distillation", False):
            raise NotImplementedError("multiview distillation")
        dino_cfg = cfg["distillation_head"]["feature_head"]
        if dino_cfg["name"] != "MultiLayerConv":
            raise NotImplementedError(dino_cfg["name"])
        self.depthcomp = DepthCompletion(cfg)
        self.dino_head = MultiLayerConv(dino_cfg)

    def forward(self, rgbd: torch.Tensor, p2p: torch.Tensor | None = None,
                drop_connect: DropConnect = None
                ) -> dict[str, torch.Tensor]:
        """rgbd [B, V, H, W, 4] (RGB in [0, 1], depth in mm) -> depth_* keys
        of DepthCompletion over B*V frames plus ``dino_pe_feats``
        [B, V, Hs, Ws, D]."""
        B, V, H, W, C = rgbd.shape
        outputs = dict(self.depthcomp(rgbd.reshape(B * V, H, W, C),
                                      drop_connect))
        feats = outputs["depth_preds_feats"]
        _, Hs, Ws, _ = feats.shape
        dino = self.dino_head(feats.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        outputs["dino_pe_feats"] = dino.reshape(B, V, Hs, Ws, dino.shape[-1])
        return outputs
