"""MaxEnt IRL model, deployment form: TerrainNet + VIN reward head.

Counterpart of ``creste_public_tpu/models/lfd.py`` with ``solve_mdp=False``
(the graph the reference exports for its runtime). Solving the MDP, the
policy rollouts and their kernels are not ported yet.
"""
from __future__ import annotations

from typing import Any

import torch
from torch import nn

from creste_public_tpu_torch.models.blocks.vin import VIN
from creste_public_tpu_torch.models.terrainnet import TerrainNet


class MaxEntIRL(nn.Module):
    def __init__(self, cfg: Any):
        super().__init__()
        if bool(cfg.get("solve_mdp", False)):
            raise NotImplementedError("MaxEntIRL with solve_mdp=True")
        if cfg.get("compute_dtype"):
            raise NotImplementedError("MaxEntIRL with a compute_dtype")
        head_cfg = cfg["traversability_head"]
        if head_cfg["value_iterator"] != "VIN":
            raise NotImplementedError(head_cfg["value_iterator"])
        self.backbone = TerrainNet(cfg["vision_backbone"])
        self.traversability_head = VIN(head_cfg["net_kwargs"]["reward_cfg"])

    def forward(self, rgbd: torch.Tensor,
                p2p: torch.Tensor) -> dict[str, torch.Tensor]:
        """rgbd [B, N, H, W, 4], p2p [B, N, 4, 4] -> the merged NHWC dict
        with traversability_preds [B, 64, 128, 1] at production."""
        outputs = dict(self.backbone(rgbd, p2p))
        outputs.update(self.traversability_head(outputs))
        return outputs
