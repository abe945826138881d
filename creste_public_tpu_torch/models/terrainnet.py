"""TerrainNet: RGBD backbone -> BEV splat -> multi-head BEV decoder.

Counterpart of ``creste_public_tpu/models/terrainnet.py``, main-path branch
only: DistillationBackbone, Camera2MapMulti (mean splat) and the
InpaintingResNet18MultiHead decoder. The temporal layer and the movability
double-forward are training-stage features and raise here.
"""
from __future__ import annotations

from typing import Any

import torch
from torch import nn

from creste_public_tpu_torch.models.blocks.effnet import DropConnect
from creste_public_tpu_torch.models.blocks.resnet import (
    InpaintingResNet18MultiHead,
)
from creste_public_tpu_torch.models.blocks.splat import Camera2MapMulti
from creste_public_tpu_torch.models.distillation import DistillationBackbone


class TerrainNet(nn.Module):
    def __init__(self, cfg: Any):
        super().__init__()
        cls_name = cfg["vision_backbone"].get("class_name",
                                              "DistillationBackbone")
        if cls_name != "DistillationBackbone":
            raise NotImplementedError(f"TerrainNet backbone {cls_name}")
        if cfg.get("use_temporal", False):
            raise NotImplementedError("TerrainNet temporal layer")
        if cfg.get("use_movability", False):
            raise NotImplementedError("TerrainNet movability")
        self.splat_key = cfg["camera_projector"].get("splat_key",
                                                     "depth_preds_feats")
        self.depthcomp = DistillationBackbone(cfg)
        self.cam2map = Camera2MapMulti(cfg["camera_projector"])
        bev_cfg = cfg.get("bev_classifier", None)
        self.has_decoder = bev_cfg is not None
        if self.has_decoder:
            kw = bev_cfg["net_kwargs"]
            if kw.get("merged_heads", False) or kw.get(
                    "learnable_loss_weight", False):
                raise NotImplementedError("merged_heads / learnable weights")
            self.bevclassifier = InpaintingResNet18MultiHead(
                int(kw["num_input_features"]), tuple(kw["num_classes"]),
                tuple(kw["output_prefix"]),
                kw.get("input_key", "bev_features"))

    def forward(self, rgbd: torch.Tensor, p2p: torch.Tensor,
                mv_mask: torch.Tensor | None = None,
                drop_connect: DropConnect = None
                ) -> dict[str, torch.Tensor]:
        """rgbd [B, N, H, W, 4], p2p [B, N, 4, 4] -> the merged NHWC dict
        (depth_*, dino_pe_feats, bev_*, inpainting_*, elevation_*).
        ``mv_mask`` [B, N, Hs, Ws] is the movability mask, which only the
        movability branch reads (not ported: the constructor raises), so it
        has no effect here, as in the JAX model with ``use_movability``
        off. ``drop_connect`` is the EffNet trunk's mask source in
        training."""
        del mv_mask
        B, N = rgbd.shape[:2]
        outputs = dict(self.depthcomp(rgbd, p2p, drop_connect))
        feats = outputs[self.splat_key]
        Hs, Ws, Z = feats.shape[-3:]
        depth = outputs["depth_preds_metric"].reshape(B, N, Hs, Ws)
        outputs.update(self.cam2map(depth, feats.reshape(B, N, Hs, Ws, Z),
                                    p2p))
        if self.has_decoder:
            outputs.update(self.bevclassifier(outputs))
        return outputs
