"""Programmatic config presets: a plain-dict copy of the JAX package's
``config/presets.py`` for the models the port runs.

Values and structure are the reference's (stage-1 DistillationBackbone,
single-view and PE-free multiview, stage-2 TerrainNet, stage-3 MaxEntIRL).
The tiny_* presets build structurally identical miniature models for CPU
tests.
"""
from __future__ import annotations

from creste_public_tpu_torch.config.config import Config


def discretize_cfg(num_bins: int = 128, depth_max: int = 25600) -> dict:
    return {
        "mode": "UD",
        "num_bins": num_bins,
        "depth_min": 300,  # mm
        "depth_max": depth_max,  # mm
    }


def distillation_model_config(
    image_size=(512, 612),
    depth_embed_dim: int = 256,
    fdn_embed_dim: int = 128,
    num_depth_bins: int = 128,
    depth_max: int = 25600,
) -> Config:
    """Stage-1 DistillationBackbone config (effnet_ds2_dinov2_128.yaml)."""
    return Config(
        {
            "project_name": "Dinov2Distillation",
            "views": 1,
            "discretize": discretize_cfg(num_depth_bins, depth_max),
            "vision_backbone": {
                "class_name": "DistillationBackbone",
                "name": "efficientnet-b0",
                "input_type": "rgbd",
                "return_feats": True,
                "effnet_cfgs": {
                    "in_channels": 4,
                    "out_channels": depth_embed_dim,
                    "downsample": 4,
                    "image_size": list(image_size),
                },
            },
            "depth_head": {
                "name": "depthconv-head",
                "dims": [depth_embed_dim, num_depth_bins],
                "kernels": [3],
                "paddings": [1],
                "norm_type": "batch_norm",
            },
            "distillation_head": {
                "name": "distillation-head",
                "feature_head": {
                    "name": "MultiLayerConv",
                    "kernels": [1, 1, 1],
                    "paddings": [0, 0, 0],
                    "dims": [depth_embed_dim, 128, 128, fdn_embed_dim],
                    "norm_type": "batch_norm",
                },
            },
            "batch_size": 4,
            "optimizer": {"name": "Adam", "beta1": 0.9, "beta2": 0.999,
                          "lr": 0.0005, "eps": 1e-7},
            "lr_scheduler": {"name": "ExponentialLR", "gamma": 0.98},
            "loss": [
                {"name": "CrossEntropyDepth", "weight": 0.5,
                 "pred_key": "outputs/depth_preds_logits",
                 "lab_key": "inputs/depth_label",
                 "discretize": discretize_cfg(num_depth_bins, depth_max)},
                {"name": "SmoothL1Depth", "weight": 0.1,
                 "pred_key": "outputs/depth_preds_metric",
                 "lab_key": "inputs/depth_label", "beta": 0.5,
                 "discretize": discretize_cfg(num_depth_bins, depth_max)},
                {"name": "MSELoss", "weight": 1.0,
                 "pred_key": "outputs/dino_pe_feats",
                 "lab_key": "inputs/fimg_label", "overlap_only": False},
            ],
        }
    )


def distillation_pefree_config(
    image_size=(512, 612),
    grid: int = 256,
    map_range: float = 12.8,
    depth_embed_dim: int = 256,
    fdn_embed_dim: int = 128,
    num_depth_bins: int = 128,
    depth_max: int = 25600,
    num_views: int = 2,
    z_embed_dim: int = 32,
) -> Config:
    """Stage-1 PE-free multiview variant: learnable PE map + multiview
    splat + PEFreeMSELoss consistency (distillation.py:58-127, the code
    path behind the reference's PE-free training; no public YAML exists,
    so this preset IS the config surface)."""
    base = distillation_model_config(
        image_size, depth_embed_dim, fdn_embed_dim, num_depth_bins, depth_max
    )
    hs, ws = image_size[0] // 4, image_size[1] // 4
    voxel = 2 * map_range / grid
    base.update(Config({
        "project_name": "Dinov2PEFreeDistillation",
        "views": num_views + 1,
        "multiview_distillation": True,
        "fdn_embed_dim": fdn_embed_dim,
        "pe_map": {"height": hs // 2, "width": ws // 2, "use_norm": False},
        "camera_projector": {
            "name": "Cam2MapMulti",
            "voxel_size": [voxel, voxel, 3],
            "point_cloud_range": [
                -map_range, -map_range, -2, map_range, map_range, 1
            ],
            "embed_z": True,
            "z_embed_dim": z_embed_dim,
            "z_embed_mode": "mlp",
            "num_cams": 1,
            "splat_key": "depth_preds_feats",
            "vision_fusion": {
                "name": "ConvEncoder",
                "dims": [fdn_embed_dim + z_embed_dim, fdn_embed_dim],
                "kernels": [1],
                "paddings": [0],
                "norm_type": "batch_norm",
            },
        },
        "loss": list(base["loss"]) + [
            {"name": "PEFreeMSELoss", "weight": 1.0,
             "num_views": num_views,
             "pred_key": "outputs/bev_features",
             "lab_key": "outputs/bev_densities",
             "density_threshold": 1e-3},
        ],
    }))
    return base


def terrainnet_model_config(
    image_size=(512, 612),
    grid: int = 256,
    map_range: float = 12.8,
    depth_embed_dim: int = 256,
    fdn_embed_dim: int = 128,
    num_depth_bins: int = 128,
    depth_max: int = 25600,
    inpainting_sam_dim: int = 32,
    num_obj_class: int = 6,
    z_embed_dim: int = 32,
    bev_feat_dim: int = 96,
) -> Config:
    """Stage-2 TerrainNet config (terrainnet_supcon_sam2dynelev_jointdinopretrain.yaml)."""
    base = distillation_model_config(
        image_size, depth_embed_dim, fdn_embed_dim, num_depth_bins, depth_max
    )
    voxel = 2 * map_range / grid
    base = Config(base)
    base.update(
        Config(
            {
                "project_name": "TerrainNetSAM",
                "load_setting": "strict",
                "use_temporal": False,
                "use_movability": False,
                "multiview_distillation": False,
                "fdn_embed_dim": fdn_embed_dim,
                "views": 1,
                "camera_projector": {
                    "name": "Cam2MapMulti",
                    "voxel_size": [voxel, voxel, 3],
                    "point_cloud_range": [
                        -map_range, -map_range, -2, map_range, map_range, 1
                    ],
                    "embed_z": True,
                    "z_embed_dim": z_embed_dim,
                    "z_embed_mode": "mlp",
                    "num_cams": 1,
                    "splat_key": "depth_preds_feats",
                    "vision_fusion": {
                        "name": "ConvEncoder",
                        "dims": [depth_embed_dim + z_embed_dim, bev_feat_dim],
                        "kernels": [1],
                        "paddings": [0],
                        "norm_type": "batch_norm",
                    },
                },
                "bev_classifier": {
                    "name": "InpaintingResNet18MultiHead",
                    "net_kwargs": {
                        "input_key": "bev_features",
                        "num_input_features": bev_feat_dim,
                        "num_classes": [inpainting_sam_dim, num_obj_class, 2],
                        "output_prefix": [
                            "inpainting_sam", "inpainting_sam_dynamic", "elevation"
                        ],
                    },
                },
                "batch_size": 8,
                "lr_scheduler": {"name": "ExponentialLR", "gamma": 0.98},
                # stage-2 loss set (terrainnet_supcon_sam2dynelev_
                # jointdinopretrain.yaml:92-135); class-weight files are
                # optional — absent => uniform weights.
                "loss": [
                    {"name": "SupPixelConLoss", "views": 1, "weight": 1.0,
                     "pred_key": "outputs/inpainting_sam_preds",
                     "lab_key": "inputs/3d_sam_label",
                     "ignore_index": 0, "temperature": 0.1, "task": "joint"},
                    {"name": "CrossEntropy", "weight": 2.0,
                     "pred_key": "outputs/inpainting_sam_dynamic_preds",
                     "lab_key": "inputs/3d_sam_dynamic_label",
                     "num_class": num_obj_class, "class_dim": 1,
                     "task": "joint"},
                    {"name": "MSELoss", "weight": 2.0,
                     "pred_key": "outputs/dino_pe_feats",
                     "lab_key": "inputs/fimg_label", "overlap_only": False},
                    {"name": "CrossEntropyDepth", "weight": 0.5,
                     "pred_key": "outputs/depth_preds_logits",
                     "lab_key": "inputs/depth_label",
                     "discretize": discretize_cfg(num_depth_bins, depth_max)},
                    {"name": "SmoothL1Depth", "weight": 0.1,
                     "pred_key": "outputs/depth_preds_metric",
                     "lab_key": "inputs/depth_label", "beta": 0.5,
                     "discretize": discretize_cfg(num_depth_bins, depth_max)},
                    {"name": "SmoothL1", "weight": 3.0, "beta": 0.2,
                     "pred_key": "outputs/elevation_preds",
                     "lab_key": "inputs/elevation_label",
                     "absolute": False, "task": "joint"},
                ],
            }
        )
    )
    return base


def traversability_model_config(
    image_size=(512, 612),
    grid: int = 256,
    map_range: float = 12.8,
    map_ds: int = 2,
    action_horizon: int = 50,
    **terrain_kwargs,
) -> Config:
    """Stage-3 MaxEntIRL config (terrainnet_maxentirlcf_msfcn_sam2dynsemelev.yaml)."""
    terrain = terrainnet_model_config(
        image_size=image_size, grid=grid, map_range=map_range, **terrain_kwargs
    )
    sam_dim = terrain.bev_classifier.net_kwargs.num_classes[0]
    obj_dim = terrain.bev_classifier.net_kwargs.num_classes[1]
    feats_dim = sam_dim + obj_dim + 2
    Hm, Wm = grid // (2 * map_ds), grid // map_ds
    return Config(
        {
            "project_name": "TraversabilityLearning",
            "map_ds": map_ds,
            "views": 1,
            "action_horizon": action_horizon,
            "zero_terminal_state": False,
            "policy_method": "pp",
            "policy_kwargs": {"method": "sharpen", "temperature": 0.005},
            "solve_mdp": True,
            "map_size": [Hm, Wm],
            "freeze_weights": True,
            "vision_backbone": terrain.to_dict(),
            "traversability_head": {
                "name": "MaxEntIRL",
                "value_iterator": "VIN",
                "feats_dim": feats_dim,
                "map_size": grid // map_ds,
                "policy_method": "pp",
                "net_kwargs": {
                    "reward_cfg": {
                        "name": "MultiScaleFCN",
                        "ds": map_ds,
                        "input_keys": [
                            "inpainting_sam_preds",
                            "inpainting_sam_dynamic_preds",
                            "elevation_preds",
                        ],
                        "output_prefix": ["traversability_preds"],
                        "net_kwargs": {
                            "prepool": {
                                "dims": [feats_dim, 64, 32],
                                "kernels": [5, 3],
                                "stride": [1, 1],
                                "norm_type": "batch_norm",
                            },
                            "skip": {
                                "dims": [32, 32, 16],
                                "kernels": [3, 1],
                                "stride": [1, 1],
                                "norm_type": "batch_norm",
                            },
                            "trunk": {
                                "dims": [32, 32, 32],
                                "kernels": [3, 1],
                                "stride": [1, 1],
                                "norm_type": "batch_norm",
                            },
                            "postpool": {
                                "dims": [48, 1],
                                "kernels": [1],
                                "stride": [1],
                                "norm_type": "batch_norm",
                            },
                        },
                    },
                    "qvalue_cfg": {
                        "dims": [1, 8],
                        "kernels": [3],
                        "stride": [1],
                        "padding": [1],
                        "input_keys": ["traversability"],
                        "norm_type": "batch_norm",
                        "discount": 0.99,
                    },
                },
            },
            "batch_size": 10,
            "optimizer": {"name": "Adam", "beta1": 0.9, "beta2": 0.999,
                          "lr": 0.0005},
            "lr_scheduler": {"name": "ExponentialLR", "gamma": 0.96},
            "loss": [
                {"name": "MaxEntIRLLoss", "weight": 1.0, "map_ds": map_ds,
                 "map_sz": [Hm, Wm], "maxent_weight": 1.0,
                 "reward_weight": 0.01, "alpha": 0.5, "use_fov_mask": True,
                 "pred_key": "outputs/exp_svf", "fov_key": "inputs/fov_mask",
                 "lab_key": "inputs/traversability_label",
                 "cf_key": "inputs/counterfactuals_label"},
            ],
        }
    )


def tiny_kwargs() -> dict:
    """Structurally-identical miniature shapes for tests (CPU-friendly)."""
    return dict(
        image_size=(64, 80),
        depth_embed_dim=32,
        fdn_embed_dim=16,
        num_depth_bins=16,
        depth_max=3200,
    )


def _shrink_trunk(cfg: Config) -> Config:
    """Cap the EffNet trunk at 1 block/stage in tiny test configs: same
    endpoint pyramid, channels and strides, ~2x fewer ops to compile."""
    vb = cfg["vision_backbone"]
    while "effnet_cfgs" not in vb:
        vb = vb["vision_backbone"]
    vb["effnet_cfgs"]["stage_repeats"] = 1
    return cfg


def tiny_distillation_config() -> Config:
    """Stage-1 single-view miniature."""
    return _shrink_trunk(distillation_model_config(**tiny_kwargs()))


def tiny_depth_config() -> Config:
    """Stage-0 depth-only miniature (configs/model/distillation/
    depth_only.yaml shapes, CPU-friendly)."""
    base = distillation_model_config(**tiny_kwargs())
    base["project_name"] = "DepthCompletion"
    del base["distillation_head"]
    base["loss"] = [lc for lc in base["loss"] if lc["name"] != "MSELoss"]
    return _shrink_trunk(base)


def tiny_pefree_config() -> Config:
    """Stage-1 PE-free multiview miniature (V=2 views)."""
    return _shrink_trunk(distillation_pefree_config(
        grid=32, map_range=1.6, num_views=1, z_embed_dim=8, **tiny_kwargs()
    ))


def tiny_terrainnet_config() -> Config:
    return _shrink_trunk(terrainnet_model_config(
        grid=32,
        map_range=1.6,
        inpainting_sam_dim=8,
        num_obj_class=6,
        z_embed_dim=8,
        bev_feat_dim=16,
        **tiny_kwargs(),
    ))


def tiny_traversability_config() -> Config:
    return _shrink_trunk(traversability_model_config(
        grid=32,
        map_range=1.6,
        map_ds=2,
        action_horizon=10,
        inpainting_sam_dim=8,
        num_obj_class=6,
        z_embed_dim=8,
        bev_feat_dim=16,
        **tiny_kwargs(),
    ))
