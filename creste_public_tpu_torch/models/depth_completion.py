"""Depth completion: RGBD -> dense features + per-pixel depth distribution.

Counterpart of ``creste_public_tpu/models/depth_completion.py``. The EffNet
trunk gives ``depth_embed_dim`` features at downsample ``ds``; a
MultiLayerConv head gives per-bin depth logits; the metric depth is the
softmax expectation over the bin values, in metres. ``DepthCompletionModel``
is the stage-0 (depth-only) model over multiview frames. A config
``compute_dtype`` (``"bfloat16"``) runs the EffNet stream in that dtype
(``effnet``); the depth head reads the features in f32, so its logits and
the metric depth that places the splat stay f32.
"""
from __future__ import annotations

from typing import Any

import torch
from torch import nn

from creste_public_tpu_torch.models.blocks.convnets import MultiLayerConv
from creste_public_tpu_torch.models.blocks.effnet import DropConnect, EffNet
from creste_public_tpu_torch.utils import depth as du


def stream_dtype(cfg: Any) -> torch.dtype | None:
    """The torch dtype a model config's ``compute_dtype`` names (None: f32
    throughout)."""
    name = cfg.get("compute_dtype", None)
    return getattr(torch, name) if name else None


class VisionEncoder(nn.Module):
    """Encoder selector (reference vision_encoder.py:8-54): NCHW in, the
    projected EffNet features NCHW out."""

    def __init__(self, cfg: Any, compute_dtype: torch.dtype | None = None):
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
            compute_dtype=compute_dtype,
        )

    def forward(self, x: torch.Tensor,
                drop_connect: DropConnect = None) -> torch.Tensor:
        return self.effnet(x, drop_connect)[0]


class DepthCompletionModel(nn.Module):
    """The stage-0 model: frames [B, V, H, W, C] -> the DepthCompletion
    outputs over B*V frames (the reference's depth-only stage,
    CODaDepthModule)."""

    def __init__(self, cfg: Any):
        super().__init__()
        self.depthcomp = DepthCompletion(cfg)

    def forward(self, rgbd: torch.Tensor, p2p: torch.Tensor | None = None,
                drop_connect: DropConnect = None
                ) -> dict[str, torch.Tensor]:
        """``p2p`` is not read (the stages share their positional
        arguments)."""
        B, V, H, W, C = rgbd.shape
        return dict(self.depthcomp(rgbd.reshape(B * V, H, W, C),
                                   drop_connect))


class DepthCompletion(nn.Module):
    """RGBD [B, H, W, C] -> {depth_preds_logits [B, Hs, Ws, D],
    depth_preds_metric [B, Hs, Ws] (metres), depth_preds_bins,
    depth_preds_feats [B, Hs, Ws, Z]}, all NHWC."""

    def __init__(self, cfg: Any):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = stream_dtype(cfg)
        self.vision_backbone = VisionEncoder(cfg["vision_backbone"],
                                             self.compute_dtype)
        self.depth_head = MultiLayerConv(cfg["depth_head"])

    def forward(self, x: torch.Tensor, drop_connect: DropConnect = None
                ) -> dict[str, torch.Tensor]:
        """``drop_connect``: the EffNet trunk's mask source in training
        (``effnet.drop_connect_mask``)."""
        feats = self.vision_backbone(x.permute(0, 3, 1, 2).contiguous(),
                                     drop_connect)
        outputs = self.predict_depth(feats)
        if self.cfg["vision_backbone"].get("return_feats", True):
            outputs["depth_preds_feats"] = feats.permute(0, 2, 3, 1)
        return outputs

    def predict_depth(self, feats: torch.Tensor) -> dict[str, torch.Tensor]:
        """The depth head on the trunk's features [B, Z, Hs, Ws], read in
        f32: ``depth_preds_logits``, ``depth_preds_metric`` (metres) and
        ``depth_preds_bins``, NHWC."""
        disc = self.cfg["discretize"]
        head_in = feats.float() if self.compute_dtype is not None else feats
        logits = self.depth_head(head_in).permute(0, 2, 3, 1)
        metric_mm = du.metric_depth_from_logits(
            logits, disc["mode"], float(disc["depth_min"]),
            float(disc["depth_max"]), int(disc["num_bins"]))
        return {
            "depth_preds_logits": logits,
            "depth_preds_metric": metric_mm / 1000.0,
            "depth_preds_bins": logits.argmax(dim=-1).to(torch.int32),
        }
