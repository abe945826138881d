"""Distillation backbone: depth completion + DINOv2 feature head.

Counterpart of ``creste_public_tpu/models/distillation.py``: DepthCompletion,
the ``dino_head`` (a 1x1-conv MLP predicting DINOv2 features), and, with a
``pe_map`` config, the PE-free branch of stage 1: a globally learned
positional-encoding map ``learnable_pe_map`` resized bilinearly to the
feature map and projected by ``pe_head_conv`` (and ``pe_head_bn``), added to
the DINO features, and with ``multiview_distillation`` a max-mode splat
``cam2map`` of the PE-free features of every view (the reference's
cross-view consistency target, distillation.py:54).
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from creste_public_tpu_torch.models.blocks.convnets import (
    BatchNorm,
    Conv2d,
    MultiLayerConv,
)
from creste_public_tpu_torch.models.blocks.effnet import DropConnect
from creste_public_tpu_torch.models.blocks.splat import Camera2MapMulti
from creste_public_tpu_torch.models.depth_completion import DepthCompletion


class DistillationBackbone(nn.Module):
    def __init__(self, cfg: Any):
        super().__init__()
        dino_cfg = cfg["distillation_head"]["feature_head"]
        if dino_cfg["name"] != "MultiLayerConv":
            raise NotImplementedError(dino_cfg["name"])
        self.depthcomp = DepthCompletion(cfg)
        self.dino_head = MultiLayerConv(dino_cfg)
        pe_cfg = cfg.get("pe_map", None)
        self.cam2map = None
        if pe_cfg is None:
            self.register_parameter("learnable_pe_map", None)
            return
        # NCHW [1, fdn/2, h, w]; flax holds it NHWC [1, h, w, fdn/2]
        # (weights.from_jax_variables transposes)
        fdn = int(cfg["fdn_embed_dim"])
        self.learnable_pe_map = nn.Parameter(torch.zeros(
            1, fdn // 2, int(pe_cfg["height"]), int(pe_cfg["width"])))
        self.pe_head_conv = Conv2d(fdn // 2, fdn, 1)
        self.pe_head_bn = (BatchNorm(fdn) if pe_cfg.get("use_norm", False)
                           else None)
        if (cfg.get("multiview_distillation", False)
                and cfg.get("camera_projector") is not None):
            self.cam2map = Camera2MapMulti(cfg["camera_projector"],
                                           scatter_mode="max")

    def forward(self, rgbd: torch.Tensor, p2p: torch.Tensor | None = None,
                drop_connect: DropConnect = None
                ) -> dict[str, torch.Tensor]:
        """rgbd [B, V, H, W, 4] (RGB in [0, 1], depth in mm), p2p
        [B, V, 4, 4] (read by the multiview splat only) -> the depth_* keys
        of DepthCompletion over B*V frames plus ``dino_pe_feats``
        [B, V, Hs, Ws, D]; with a PE map also ``dino_pe`` [1, Hs, Ws, D]
        and ``dino_pefree_feats`` [B, V, Hs, Ws, D], and in multiview mode
        the splat's ``bev_features``, ``bev_densities`` [B*V, Hg, Wg, .]
        and ``bev_coords`` [B*V, Hs*Ws, 2]."""
        B, V, H, W, C = rgbd.shape
        outputs = dict(self.depthcomp(rgbd.reshape(B * V, H, W, C),
                                      drop_connect))
        feats = outputs["depth_preds_feats"]
        _, Hs, Ws, _ = feats.shape
        dino = self.dino_head(feats.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        dino = dino.reshape(B, V, Hs, Ws, dino.shape[-1])
        if self.learnable_pe_map is None:
            outputs["dino_pe_feats"] = dino
            return outputs
        pe = self.pe_head_conv(F.interpolate(
            self.learnable_pe_map, size=(Hs, Ws), mode="bilinear",
            align_corners=False))
        if self.pe_head_bn is not None:
            pe = self.pe_head_bn(pe)
        pe = pe.permute(0, 2, 3, 1)  # [1, Hs, Ws, D]
        outputs["dino_pe"] = pe
        outputs["dino_pefree_feats"] = dino
        outputs["dino_pe_feats"] = dino + pe
        if self.cam2map is not None:
            depth = outputs["depth_preds_metric"].reshape(B, V, Hs, Ws)
            outputs.update(self.cam2map(depth, dino, p2p))
        return outputs
