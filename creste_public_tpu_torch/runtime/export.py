"""The deployment inference graph (RGBD + p2p -> BEV reward).

Counterpart of ``creste_public_tpu/runtime/export.py::build_inference_fn``
with ``fused_reward=True``: the TerrainNet backbone, the VIN input view,
the BN-folded reward head on the hand-written CUDA kernel
(``ops.reward_kernel``) and the full-size reward map.
"""
from __future__ import annotations

from typing import Any, Callable, Mapping

import torch

from creste_public_tpu_torch.models.blocks.vin import (
    build_input_view,
    full_reward_map,
)
from creste_public_tpu_torch.models.lfd import MaxEntIRL
from creste_public_tpu_torch.ops.reward_kernel import (
    fold_msfcn_params,
    msfcn_fused_apply,
)
from creste_public_tpu_torch.utils.device import resolve_device


def build_inference_fn(
    cfg: Any, state: Mapping[str, torch.Tensor], device: str = "cuda",
) -> Callable[[Any, Any], dict[str, torch.Tensor]]:
    """Returns ``fn(rgbd, p2p) -> outputs`` on ``device``.

    ``cfg`` is a MaxEntIRL config (``presets.traversability_model_config``);
    ``solve_mdp`` is forced off, as in the deployment graph. ``state`` is a
    MaxEntIRL state_dict (``weights.from_jax_variables`` or
    ``init_weights``), loaded strictly. ``rgbd`` [B, 1, H, W, 4] and ``p2p``
    [B, 1, 4, 4] may be arrays or tensors; the outputs are NHWC tensors on
    ``device``: the TerrainNet maps plus ``traversability_preds``
    [B, 64, 128, 1], ``traversability_preds_full`` and ``input_view``.

    f32 throughout. cuDNN runs f32 convolutions in TF32 unless
    ``torch.backends.cudnn.allow_tf32`` is False; the parity numbers of the
    port are taken with it False.
    """
    dev = resolve_device(device)
    cfg = dict(cfg.to_dict() if hasattr(cfg, "to_dict") else cfg)
    cfg["solve_mdp"] = False
    model = MaxEntIRL(cfg)
    model.load_state_dict(state, strict=True)
    model.to(dev).eval()
    head = model.traversability_head
    folded = fold_msfcn_params(head.r)
    reward_cfg = head.reward_cfg
    input_keys = list(reward_cfg["input_keys"])
    ds = int(reward_cfg["ds"])
    prefix = reward_cfg["output_prefix"][0]

    @torch.no_grad()
    def fn(rgbd, p2p) -> dict[str, torch.Tensor]:
        rgbd = torch.as_tensor(rgbd, dtype=torch.float32, device=dev)
        p2p = torch.as_tensor(p2p, dtype=torch.float32, device=dev)
        outputs = dict(model.backbone(rgbd, p2p))
        iv = build_input_view(outputs, input_keys, ds)
        r = msfcn_fused_apply(folded, iv)
        Ho, Wo = outputs[input_keys[0]].shape[1:3]
        outputs.update({prefix: r, f"{prefix}_full": full_reward_map(r, Ho, Wo),
                        "input_view": iv})
        return outputs

    return fn
