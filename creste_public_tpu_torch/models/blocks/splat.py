"""Camera-to-BEV splat projection module.

Counterpart of ``creste_public_tpu/models/blocks/splat.py`` (reference
Camera2MapMulti, splat_projection.py:53-354): depth + p2p -> LiDAR-frame
points -> z-MLP elevation embedding -> 1x1-conv vision fusion -> in-range
mask -> voxel coords -> bilinear splat, in mean mode (TerrainNet) or in max
mode (the multiview distillation branch). In training a movability mask
keeps only the static pixels, and the outputs then carry the suffix
``_mv``.
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
    ``scatter_mode`` is the splat's mode ('mean', 'sum' or 'max').
    """

    def __init__(self, cfg: Any, scatter_mode: str = "mean"):
        super().__init__()
        self.scatter_mode = scatter_mode
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
                p2p: torch.Tensor, mv_mask: torch.Tensor | None = None
                ) -> dict[str, torch.Tensor]:
        """
        Args:
          depth: [B, N, H, W] metric depth (metres).
          feats: [B, N, H, W, F] image features.
          p2p:   [B, N, 4, 4] pixel->LiDAR transform.
          mv_mask: optional [B, N, H, W] movability mask, read in training
            only: a pixel splats where it is > 0 (and in range).

        Returns 'bev_features' [B*NS, Hg, Wg, C], 'bev_densities'
        [B*NS, Hg, Wg, 1] and 'bev_coords' [B*NS, NC*H*W, 2], each key
        with the suffix '_mv' when the mask was applied.
        """
        B, N, H, W = depth.shape
        xyz = geo.backproject_depth(depth, p2p)  # [B, N, H, W, 3]

        z_feats = self.z_proj(xyz[..., 2:3].to(feats.dtype))
        fused = torch.cat([feats, z_feats], dim=-1).reshape(B * N, H, W, -1)
        fused = self.vision_fusion(fused.permute(0, 3, 1, 2).contiguous())
        fused = fused.permute(0, 2, 3, 1).reshape(B, N, H, W, -1)
        C = fused.shape[-1]

        # the geometry is f32 whatever the features' dtype, as in the JAX
        # package: a module cast to f64 keeps its constants f32 here
        g = xyz.dtype
        mask = geo.point_in_range_mask(xyz, self.min_bound.to(g),
                                       self.max_bound.to(g))
        suffix = ""
        if self.training and mv_mask is not None:
            mask = mask & (mv_mask > 0)
            suffix = "_mv"
        fused = fused * mask[..., None]

        if N % self.nc:
            raise ValueError(f"Number of frames must be divisible by {self.nc}")
        ns = N // self.nc
        xy = geo.points_to_voxels(xyz, self.l2m.to(g),
                                  self.voxel_xy.to(g))
        xy = xy.reshape(B * ns, self.nc * H * W, 2)
        fused = fused.reshape(B * ns, self.nc * H * W, C)

        bev, dens = splat_to_bev(xy, fused, self.grid_hw,
                                 mode=self.scatter_mode, min_weight=1.0)
        return {f"bev_features{suffix}": bev,
                f"bev_densities{suffix}": dens, f"bev_coords{suffix}": xy}
