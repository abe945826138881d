"""TerrainNet: RGBD backbone -> BEV splat -> [temporal merge] -> multi-head
BEV decoder.

Counterpart of ``creste_public_tpu/models/terrainnet.py``: the backbone
(DistillationBackbone, or DepthCompletion on the frames folded into the
batch), Camera2MapMulti (mean splat), the optional ConvGRU MergeUnit
(``use_temporal``) and the InpaintingResNet18MultiHead decoder. With
``use_movability`` in training the anchor view is splatted, then every view
with the movability mask (outputs ``*_mv``), and the decoder runs twice:
plain, then on the masked features with ``key_suffix="_mv"``; its
train-mode BatchNorms stage their running statistics once per call, in
that order, as flax's two calls in one ``apply`` update them.
"""
from __future__ import annotations

from typing import Any, Sequence

import torch
from torch import nn

from creste_public_tpu_torch.models.blocks.convgru import MergeUnit, PoseNoise
from creste_public_tpu_torch.models.blocks.effnet import DropConnect
from creste_public_tpu_torch.models.blocks.resnet import (
    InpaintingResNet18MultiHead,
)
from creste_public_tpu_torch.models.blocks.splat import Camera2MapMulti
from creste_public_tpu_torch.models.depth_completion import DepthCompletion
from creste_public_tpu_torch.models.distillation import DistillationBackbone

_BACKBONES = {"DistillationBackbone": DistillationBackbone,
              "DepthCompletion": DepthCompletion}


class TerrainNet(nn.Module):
    def __init__(self, cfg: Any):
        super().__init__()
        self.backbone_cls = cfg["vision_backbone"].get("class_name",
                                                       "DistillationBackbone")
        if self.backbone_cls not in _BACKBONES:
            raise KeyError(f"TerrainNet backbone {self.backbone_cls}")
        proj = cfg["camera_projector"]
        self.splat_key = proj.get("splat_key", "depth_preds_feats")
        self.use_movability = bool(cfg.get("use_movability", False))
        self.depthcomp = _BACKBONES[self.backbone_cls](cfg)
        self.cam2map = Camera2MapMulti(proj)
        self.use_temporal = bool(cfg.get("use_temporal", False))
        if self.use_temporal:
            t_cfg = cfg["temporal_layer"]["net_kwargs"]
            self.use_pose = bool((t_cfg.get("rnn_config", None) or {}).get(
                "use_pose", False))
            self.temporal_layer = MergeUnit(
                t_cfg, int(proj["vision_fusion"]["dims"][-1]))
        bev_cfg = cfg.get("bev_classifier", None)
        self.has_decoder = bev_cfg is not None
        if self.has_decoder:
            kw = bev_cfg["net_kwargs"]
            self.bevclassifier = InpaintingResNet18MultiHead(
                int(kw["num_input_features"]), tuple(kw["num_classes"]),
                tuple(kw["output_prefix"]),
                kw.get("input_key", "bev_features"),
                learnable_loss_weight=kw.get("learnable_loss_weight", False),
                merged_heads=kw.get("merged_heads", False))

    def forward(self, rgbd: torch.Tensor, p2p: torch.Tensor,
                mv_mask: torch.Tensor | None = None,
                drop_connect: DropConnect = None,
                temporal_hidden: Sequence[Any] | None = None,
                bos: bool = True, pose: torch.Tensor | None = None,
                pose_noise: PoseNoise = None) -> dict[str, torch.Tensor]:
        """rgbd [B, N, H, W, 4], p2p [B, N, 4, 4] -> the merged NHWC dict
        (depth_*, dino_pe_feats, bev_*, inpainting_*, elevation_*).

        ``mv_mask`` [B, N, Hs, Ws] is the movability mask (read in
        training with ``use_movability``); ``drop_connect`` the EffNet
        trunk's mask source in training. With ``use_temporal``:
        ``temporal_hidden`` the previous chunk's hidden state (ignored at
        ``bos``), ``pose`` [B, N, 4, 4] (required with ``use_pose``),
        ``pose_noise`` the noisy pose's source; the outputs then hold
        ``merged_bev_features`` (the last frame's) and ``temporal_hidden``.
        """
        B, N, H, W, C = rgbd.shape
        if self.backbone_cls == "DistillationBackbone":
            outputs = dict(self.depthcomp(rgbd, p2p, drop_connect))
        else:
            outputs = dict(self.depthcomp(rgbd.reshape(B * N, H, W, C),
                                          drop_connect))
        feats = outputs[self.splat_key]
        Hs, Ws, Z = feats.shape[-3:]
        # grouped by the frame count (temporal chunks feed N > views)
        depth = outputs["depth_preds_metric"].reshape(B, N, Hs, Ws)
        feats = feats.reshape(B, N, Hs, Ws, Z)
        movability = self.training and self.use_movability
        if movability:
            # the anchor view's splat, then every view's with the mask
            outputs.update(self.cam2map(depth[:, 0:1], feats[:, 0:1],
                                        p2p[:, 0:1]))
            if mv_mask is not None:
                outputs.update(self.cam2map(depth, feats, p2p, mv_mask))
        else:
            outputs.update(self.cam2map(depth, feats, p2p))

        if self.use_temporal:
            ns = outputs["bev_features"].shape[0] // B
            pose_bt = None
            if self.use_pose:
                if pose is None:
                    raise ValueError(
                        "rnn_config.use_pose=True needs the batch's 'pose' "
                        "([B, N, 4, 4]) passed as pose=")
                pose_bt = pose.reshape(B * ns, 4, 4)
            merged = self.temporal_layer(
                outputs["bev_features"], t=ns, hidden=temporal_hidden,
                bos=bos, pose=pose_bt, noise=pose_noise)
            if isinstance(merged, tuple):
                merged, outputs["temporal_hidden"] = merged
            outputs["merged_bev_features"] = merged.reshape(
                B, ns, *merged.shape[1:])[:, -1]

        if self.has_decoder:
            outputs.update(self.bevclassifier(outputs))
            if movability and mv_mask is not None:
                outputs.update(self.bevclassifier(outputs, key_suffix="_mv"))
        return outputs
