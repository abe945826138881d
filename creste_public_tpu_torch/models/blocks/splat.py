"""Camera-to-BEV splat projection module.

Counterpart of ``creste_public_tpu/models/blocks/splat.py`` (reference
Camera2MapMulti, splat_projection.py:53-354): depth + p2p -> LiDAR-frame
points -> z-MLP elevation embedding -> 1x1-conv vision fusion -> in-range
mask -> voxel coords -> bilinear mean splat. The movability-mask training
branch and the max-mode splat of multiview distillation are not ported.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch import nn

from creste_public_tpu_torch.models.blocks.convnets import MLP, ConvEncoder
from creste_public_tpu_torch.ops.splat import splat_to_bev
from creste_public_tpu_torch.utils import geometry as geo


class Camera2MapMulti(nn.Module):
    """Lift image features into a BEV grid.

    cfg keys: point_cloud_range [xmin, ymin, zmin, xmax, ymax, zmax],
    voxel_size [vx, vy, vz], z_embed_dim, z_embed_mode ('mlp'), num_cams,
    vision_fusion (ConvEncoder cfg, dims [F + z_embed_dim, C]).
    """

    def __init__(self, cfg: Any):
        super().__init__()
        if cfg.get("z_embed_mode", "mlp") != "mlp":
            raise ValueError(f"Unknown z_embed_mode: {cfg['z_embed_mode']}")
        pcr = np.asarray(list(cfg["point_cloud_range"]), np.float32)
        voxel = np.asarray(list(cfg["voxel_size"]), np.float32)
        self.grid_hw = (
            int(round((pcr[3] - pcr[0]) / voxel[0])),
            int(round((pcr[4] - pcr[1]) / voxel[1])),
        )
        self.nc = int(cfg.get("num_cams", 1))
        self.register_buffer("min_bound", torch.from_numpy(pcr[:3]),
                             persistent=False)
        self.register_buffer("max_bound", torch.from_numpy(pcr[3:]),
                             persistent=False)
        self.register_buffer("voxel_xy", torch.from_numpy(voxel[:2]),
                             persistent=False)
        self.register_buffer(
            "l2m", torch.from_numpy(geo.lidar_to_map_matrix(pcr[:3])),
            persistent=False)
        zdim = int(cfg["z_embed_dim"])
        self.z_proj = MLP(1, (zdim * 2, zdim))
        self.vision_fusion = ConvEncoder(cfg["vision_fusion"])

    def forward(self, depth: torch.Tensor, feats: torch.Tensor,
                p2p: torch.Tensor) -> dict[str, torch.Tensor]:
        """
        Args:
          depth: [B, N, H, W] metric depth (metres).
          feats: [B, N, H, W, F] image features.
          p2p:   [B, N, 4, 4] pixel->LiDAR transform.

        Returns 'bev_features' [B*NS, Hg, Wg, C], 'bev_densities'
        [B*NS, Hg, Wg, 1] and 'bev_coords' [B*NS, NC*H*W, 2].
        """
        B, N, H, W = depth.shape
        xyz = geo.backproject_depth(depth, p2p)  # [B, N, H, W, 3]

        z_feats = self.z_proj(xyz[..., 2:3].to(feats.dtype))
        fused = torch.cat([feats, z_feats], dim=-1).reshape(B * N, H, W, -1)
        fused = self.vision_fusion(fused.permute(0, 3, 1, 2).contiguous())
        fused = fused.permute(0, 2, 3, 1).reshape(B, N, H, W, -1)
        C = fused.shape[-1]

        mask = geo.point_in_range_mask(xyz, self.min_bound, self.max_bound)
        fused = fused * mask[..., None]

        if N % self.nc:
            raise ValueError(f"Number of frames must be divisible by {self.nc}")
        ns = N // self.nc
        xy = geo.points_to_voxels(xyz, self.l2m, self.voxel_xy)
        xy = xy.reshape(B * ns, self.nc * H * W, 2)
        fused = fused.reshape(B * ns, self.nc * H * W, C)

        bev, dens = splat_to_bev(xy, fused, self.grid_hw,
                                 mode="mean", min_weight=1.0)
        return {"bev_features": bev, "bev_densities": dens, "bev_coords": xy}
