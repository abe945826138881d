"""Value Iteration Network head: reward net + MDP solver (NHWC at the
boundary).

Counterpart of ``creste_public_tpu/models/blocks/vin.py``: the reward input
is the channel concat of configured BEV prediction maps, max-pooled by
``ds`` and cropped to the front half of the grid; the reward is a
MultiScaleFCN. With ``solve_mdp=True`` value iteration runs to convergence
on the detached reward (``ops.value_iteration``: the CUDA kernel on the
card), and its policy, Q and V come out detached.
"""
from __future__ import annotations

from typing import Any, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from creste_public_tpu_torch.models.blocks.convnets import (
    MultiScaleFCN,
    resize_bilinear,
)
from creste_public_tpu_torch.ops.value_iteration import value_iteration


def build_input_view(feat_map: dict[str, torch.Tensor],
                     input_keys: Sequence[str], ds: int) -> torch.Tensor:
    """Concat the configured NHWC maps, max-pool by ``ds``, crop the front
    half, detach (reference vin.py:103-115). Returns NHWC f32."""
    x = torch.cat([feat_map[k].permute(0, 3, 1, 2) for k in input_keys],
                  dim=1)
    x = F.max_pool2d(x, ds, ds)
    x = x[:, :, : x.shape[2] // 2]
    return x.float().detach().permute(0, 2, 3, 1)


def full_reward_map(r: torch.Tensor, Ho: int, Wo: int) -> torch.Tensor:
    """Full-size no-grad reward (vin.py:121-125): bilinear resize of the
    front-half reward [B, h, w, 1] to [B, Ho/2, Wo, 1], back half zero."""
    B = r.shape[0]
    top = resize_bilinear(r.detach().permute(0, 3, 1, 2), (Ho // 2, Wo))
    top = top.permute(0, 2, 3, 1)
    return torch.cat([top, top.new_zeros(B, Ho - Ho // 2, Wo, 1)], dim=1)


class VIN(nn.Module):
    def __init__(self, reward_cfg: Any, qvalue_cfg: Any | None = None):
        super().__init__()
        if reward_cfg["name"] != "MultiScaleFCN":
            raise NotImplementedError(reward_cfg["name"])
        self.reward_cfg = reward_cfg
        self.r = MultiScaleFCN(reward_cfg["net_kwargs"])
        self.discount = float((qvalue_cfg or {}).get("discount", 0.95))

    def reward(self, input_view: torch.Tensor) -> torch.Tensor:
        """Reward map [B, h, w, 1] from an NHWC state-feature view."""
        x = input_view.permute(0, 3, 1, 2).contiguous()
        return self.r(x).permute(0, 2, 3, 1)

    def forward(self, feat_map: dict[str, torch.Tensor],
                solve_mdp: bool = False) -> dict[str, torch.Tensor]:
        keys = self.reward_cfg["input_keys"]
        Ho, Wo = feat_map[keys[0]].shape[1:3]
        input_view = build_input_view(feat_map, keys,
                                      int(self.reward_cfg["ds"]))
        r = self.reward(input_view)
        prefix = self.reward_cfg["output_prefix"][0]
        outputs = {
            prefix: r,
            f"{prefix}_full": full_reward_map(r, Ho, Wo),
            "input_view": input_view,
        }
        if not solve_mdp:
            return outputs
        v, policy, q = value_iteration(r.detach(), self.discount,
                                       threshold=1e-3)
        outputs.update({"policy": policy, "q_estimate": q,
                        "value_estimate": v})
        return outputs
