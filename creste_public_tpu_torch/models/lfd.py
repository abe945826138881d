"""MaxEnt IRL model: TerrainNet backbone + VIN reward head + policy rollout.

Counterpart of ``creste_public_tpu/models/lfd.py``. With ``solve_mdp=False``
it is the deployment graph (RGBD + p2p -> BEV reward). With
``solve_mdp=True`` (stage-3 training) it also solves the MDP on the reward
and then either propagates the expected state-visitation frequencies
(``policy_method="pp"``: sharpen, ``expected_svf``, ``greedy_rollout``) or
runs the teacher-forced per-state linear rollout (``"fc"``). Backbone
freezing belongs to the optimizer, outside the module, as in the JAX
package; the reward input is detached, so the backbone gets no gradient
from the IRL loss either way.
"""
from __future__ import annotations

from typing import Any

import torch
from torch import nn

from creste_public_tpu_torch.models.blocks.convnets import Linear, eval_form
from creste_public_tpu_torch.models.blocks.effnet import DropConnect
from creste_public_tpu_torch.models.blocks.vin import VIN
from creste_public_tpu_torch.models.terrainnet import TerrainNet
from creste_public_tpu_torch.ops.svf import (
    expected_svf,
    greedy_rollout,
    sharpen_policy,
)
from creste_public_tpu_torch.ops.value_iteration import DYNAMICS
from creste_public_tpu_torch.utils import geometry as geo


def gaussian_2d(goal_xy: torch.Tensor, sigma: float, H: int,
                W: int) -> torch.Tensor:
    """[B, 2] goal (row, col) -> [B, H, W, 1] gaussian bump."""
    dev = goal_xy.device
    ys = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    gy = goal_xy[:, 0].float()[:, None, None]
    gx = goal_xy[:, 1].float()[:, None, None]
    g = torch.exp(-((ys - gy) ** 2 + (xs - gx) ** 2) / (2.0 * sigma**2))
    return g[..., None]


def backbone_cfg_with_dtype(cfg: Any) -> Any:
    """The TerrainNet config with a top-level ``compute_dtype`` threaded
    down into it (TerrainNet and DepthCompletion read the knob from their
    own top level); shared by ``MaxEntIRL`` and the fused deployment graph
    (``runtime.export``)."""
    vb = cfg["vision_backbone"]
    if cfg.get("compute_dtype") and not vb.get("compute_dtype"):
        vb = dict(vb, compute_dtype=cfg["compute_dtype"])
    return vb


class MaxEntIRL(nn.Module):
    def __init__(self, cfg: Any):
        super().__init__()
        head_cfg = cfg["traversability_head"]
        if head_cfg["value_iterator"] != "VIN":
            raise NotImplementedError(head_cfg["value_iterator"])
        self.backbone = TerrainNet(backbone_cfg_with_dtype(cfg))
        self.traversability_head = VIN(head_cfg["net_kwargs"]["reward_cfg"],
                                       head_cfg["net_kwargs"]["qvalue_cfg"])
        self.map_size = tuple(cfg.get("map_size", [64, 128]))
        self.policy_method = cfg.get("policy_method", "fc")
        self.action_horizon = int(cfg.get("action_horizon", 50))
        self.solve_mdp = bool(cfg.get("solve_mdp", False))
        self.zero_terminal_state = bool(cfg.get("zero_terminal_state", False))
        self.policy_cfg = cfg.get("policy_kwargs", {"method": "none"})
        self.goal_cfg = cfg.get("goal_kwargs", {})
        # flax creates the fc parameters only where the rollout calls it
        if self.solve_mdp and self.policy_method == "fc":
            self.fc = Linear(8, 8, bias=False)
        H, W = self.map_size
        fov = geo.create_trapezoidal_fov_mask(H * 2, W, 70, 70, 0, 100)
        self.register_buffer("fov_mask", torch.from_numpy(fov[:H, :W].copy()),
                             persistent=False)

    def reward(self, input_view: torch.Tensor) -> torch.Tensor:
        """The VIN reward net in its eval form (BatchNorm on the running
        statistics) whatever the module's mode: the IRL gradient penalty's
        ``reward_fn`` (``reward(iv, False)`` in the JAX package). In a
        training step it runs before the step commits the batch
        statistics, so it sees the pre-step ones."""
        with eval_form(self.traversability_head) as head:
            return head.reward(input_view)

    def expert_grid(self, expert: torch.Tensor, bev_width: int
                    ) -> torch.Tensor:
        """Expert SE(2) poses [B, T, 3, 3] on the BEV grid of width
        ``bev_width`` -> integer (row, col) [B, T, 2] on the reward map."""
        Hm, Wm = self.map_size
        S = torch.div(expert[:, :, :2, 2], bev_width // Wm,
                      rounding_mode="floor").long()
        return torch.stack([S[..., 0].clamp(0, Hm - 1),
                            S[..., 1].clamp(0, Wm - 1)], dim=-1)

    def svf_endpoints(self, S: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
        """Linear start and terminal states [B] of the SVF propagation: the
        first expert pose inside the FOV and the last expert pose."""
        Wm = self.map_size[1]
        s0_xy = geo.earliest_pose_in_fov(S, self.fov_mask)
        return s0_xy[:, 0] * Wm + s0_xy[:, 1], S[:, -1, 0] * Wm + S[:, -1, 1]

    def forward(self, rgbd: torch.Tensor, p2p: torch.Tensor,
                expert: torch.Tensor | None = None,
                drop_connect: DropConnect = None
                ) -> dict[str, torch.Tensor]:
        """rgbd [B, N, H, W, 4], p2p [B, N, 4, 4] and, when solving the
        MDP, the expert SE(2) poses [B, T, 3, 3] on the full BEV grid ->
        the merged NHWC dict: traversability_preds [B, 64, 128, 1] at
        production, plus the policy/value/Q maps and the rollout.
        ``drop_connect`` is the EffNet trunk's mask source in training
        (``effnet.drop_connect_mask``)."""
        outputs = dict(self.backbone(rgbd, p2p,
                                     drop_connect=drop_connect))
        if not self.solve_mdp:
            outputs.update(self.traversability_head(outputs))
            return outputs
        if expert is None:
            raise ValueError("the MDP solve needs the expert poses")

        B = rgbd.shape[0]
        Hb, Wb = outputs["bev_features"].shape[1:3]
        S = self.expert_grid(expert, Wb)  # [B, T, 2]

        if "method" in self.goal_cfg:
            rows = torch.arange(B, device=S.device)
            if self.goal_cfg["method"] == "gaussian":
                goal = gaussian_2d(S[:, -1], sigma=Hb / 12, H=Hb // 2, W=Wb)
            elif self.goal_cfg["method"] == "dot":
                goal = torch.zeros(B, Hb // 2, Wb, 1, device=S.device)
                goal[rows, S[:, -1, 0], S[:, -1, 1], 0] = 1.0
            else:
                raise ValueError(self.goal_cfg["method"])
            outputs["goal"] = goal

        outputs.update(self.traversability_head(outputs, solve_mdp=True))

        if self.policy_method == "pp":
            policy = outputs["policy"]  # [B, Hm, Wm, A]
            if self.policy_cfg.get("method", "none") == "sharpen":
                policy = sharpen_policy(
                    policy, float(self.policy_cfg["temperature"]))
            s0, s1 = self.svf_endpoints(S)
            mu = expected_svf(policy, s0, s1, self.action_horizon,
                              self.zero_terminal_state)
            states, states_grid = greedy_rollout(policy, s0,
                                                 self.action_horizon)
            outputs.update({"exp_svf": mu, "state_preds": states,
                            "state_preds_grid": states_grid})
        elif self.policy_method == "fc":
            outputs.update(self._fc_rollout(outputs["q_estimate"], S,
                                            self.action_horizon))
        else:
            raise ValueError(f"Policy method {self.policy_method} not found.")
        return outputs

    @torch.no_grad()
    def _fc_rollout(self, q: torch.Tensor, expert: torch.Tensor,
                    T: int) -> dict[str, torch.Tensor]:
        """Teacher-forced per-state linear policy rollout (reference
        lfd.py:279-312), detached like the reference's, which runs under
        ``torch.no_grad()``."""
        B, H, W, A = q.shape
        dyn = torch.as_tensor(DYNAMICS, dtype=torch.long, device=q.device)
        rows = torch.arange(B, device=q.device)
        state = expert[:, 0, :2]
        policies, states = [], [state]
        # the teacher inputs are the expert poses at t - 1
        for t_expert in expert[:, :-1][:, : T - 1].unbind(1):
            q_out = q[rows, t_expert[:, 0], t_expert[:, 1]]  # [B, A]
            policy = torch.softmax(self.fc(q_out), dim=-1)
            nxt = state + dyn[policy.argmax(dim=-1)]
            state = torch.stack([nxt[:, 0].clamp(0, H - 1),
                                 nxt[:, 1].clamp(0, W - 1)], dim=1)
            policies.append(policy)
            states.append(state)
        zero = torch.zeros(B, 1, A, device=q.device)
        return {"policy_fc": torch.cat([zero, torch.stack(policies, 1)], 1),
                "state_preds": torch.stack(states, dim=1)}
