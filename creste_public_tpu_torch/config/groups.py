"""The config groups the training commands compose, as plain dicts, and
the hydra-style composition over them.

Copies of the JAX package's ``configs/`` YAML files (the port and the
card's machine have no YAML): the roots ``depth.yaml``,
``distillation.yaml``, ``ssc_sam.yaml`` and ``traversability.yaml``,
``model/distillation/{depth_only,effnet_ds4_dinov2_128,tiny}``,
``model/ssc_sam/{terrainnet_supcon_sam2dynelev_jointdinopretrain,tiny}``,
``model/traversability/{terrainnet_maxentirlcf_msfcn_sam2dynsemelev,tiny}``,
``trainer/{smoke,standard,standard_single}`` and
``dataset/{coda,synthetic_pefree,synthetic_ssc,synthetic_traversability,
synthetic_tiny,synthetic_tiny_multitask}`` and
``visualize/effnet_distillation``. The model files are the presets
(``presets.distillation_model_config``, ``presets.terrainnet_model_config``
and ``presets.traversability_model_config`` at their published shapes, and
at the tiny shapes with the full trunk and ``batch_size`` 2; the stage-0
``depth_only`` is the stage-1 preset without its DINO head and loss, at
``batch_size`` 8).
``compose_cli`` is ``config.compose_cli`` of the JAX package over these
dicts.
"""
from __future__ import annotations

import copy
from typing import Iterable, Mapping

from creste_public_tpu_torch.config import presets
from creste_public_tpu_torch.config.config import (
    Config,
    apply_overrides,
    deep_merge,
)


_TINY_BEV = dict(grid=32, map_range=1.6, inpainting_sam_dim=8,
                 num_obj_class=6, z_embed_dim=8, bev_feat_dim=16,
                 **presets.tiny_kwargs())


def _tiny(make_config, **kw) -> dict:
    cfg = make_config(**_TINY_BEV, **kw).to_dict()
    cfg["batch_size"] = 2
    return cfg


def _depth_only() -> dict:
    cfg = presets.distillation_model_config().to_dict()
    del cfg["distillation_head"]
    cfg["loss"] = [lc for lc in cfg["loss"] if lc["name"] != "MSELoss"]
    cfg["project_name"] = "DepthCompletion"
    cfg["vision_backbone"]["class_name"] = "DepthCompletion"
    cfg["batch_size"] = 8
    return cfg


def _trainer(**kw) -> dict:
    cfg = {"max_epochs": 50, "max_steps": -1, "devices": None,
           "log_every_n_steps": 10, "check_val_every_n_epoch": 1,
           "save_top_k": 5, "ckpt_dir": "ckpts", "seed": 0, "verbose": True,
           "freeze_backbone_epochs": 0}
    cfg.update(kw)
    return cfg


_TINY_SHAPE = dict(image_size=[64, 80], ds=4, fdn_dim=16, grid=32,
                   map_range=1.6, horizon=10)


def _synthetic(train_length: int, val_length: int, **shape) -> dict:
    return {"name": "synthetic",
            "train": {"length": train_length, **shape},
            "val": {"length": val_length, **shape}}


ROOTS = {
    "depth": {
        "defaults": [
            {"dataset": "synthetic_pefree"},
            {"model": "distillation/depth_only"},
            {"trainer": "standard"},
            "_self_",
        ],
        "stage": "depth",
        "task": None,
    },
    "distillation": {
        "defaults": [
            {"dataset": "synthetic_pefree"},
            {"model": "distillation/effnet_ds4_dinov2_128"},
            {"trainer": "standard"},
            "_self_",
        ],
        "stage": "distillation",
        "task": None,
    },
    "ssc_sam": {
        "defaults": [
            {"dataset": "synthetic_ssc"},
            {"model": "ssc_sam/"
                      "terrainnet_supcon_sam2dynelev_jointdinopretrain"},
            {"trainer": "standard"},
            "_self_",
        ],
        "stage": "ssc",
        "task": "joint",
    },
    "traversability": {
        "defaults": [
            {"dataset": "synthetic_traversability"},
            {"model": "traversability/"
                      "terrainnet_maxentirlcf_msfcn_sam2dynsemelev"},
            {"trainer": "standard"},
            "_self_",
        ],
        "stage": "traversability",
        "task": None,
    },
}

GROUPS = {
    "dataset": {
        # the UT CODa on-disk layout (README.md:78-108 of the reference)
        "coda": {"name": "coda", "root": "data/creste", "views": 1, "ds": 4,
                 "grid": 256, "map_range": 12.8,
                 "split_dir": "data/creste/splits"},
        "synthetic_pefree": _synthetic(
            32, 8, image_size=[512, 612], ds=4, fdn_dim=128),
        "synthetic_ssc": _synthetic(
            32, 8, image_size=[512, 612], ds=4, fdn_dim=128, grid=256,
            map_range=12.8),
        "synthetic_traversability": _synthetic(
            32, 8, image_size=[512, 612], ds=4, fdn_dim=128, grid=256,
            map_range=12.8, horizon=50),
        "synthetic_tiny": _synthetic(4, 2, **_TINY_SHAPE),
        "synthetic_tiny_multitask": {"name": "synthetic", "tasks": {
            "joint": _synthetic(4, 2, **_TINY_SHAPE),
            "depth": _synthetic(2, 2, **_TINY_SHAPE)}},
    },
    "model": {
        "distillation/depth_only": _depth_only(),
        "distillation/effnet_ds4_dinov2_128":
            presets.distillation_model_config().to_dict(),
        "distillation/tiny": dict(
            presets.distillation_model_config(**presets.tiny_kwargs())
            .to_dict(), batch_size=2),
        "ssc_sam/terrainnet_supcon_sam2dynelev_jointdinopretrain":
            presets.terrainnet_model_config().to_dict(),
        "ssc_sam/tiny": _tiny(presets.terrainnet_model_config),
        "traversability/terrainnet_maxentirlcf_msfcn_sam2dynsemelev":
            presets.traversability_model_config().to_dict(),
        "traversability/tiny": _tiny(presets.traversability_model_config,
                                     map_ds=2, action_horizon=10),
    },
    "trainer": {
        "smoke": _trainer(max_epochs=1, max_steps=2, log_every_n_steps=1,
                          save_top_k=1, ckpt_dir="/tmp/creste_tpu_smoke"),
        "standard": _trainer(),
        "standard_single": _trainer(devices=1),
    },
    # turns on the validation images (training/visual_log.py), written
    # as PNGs under save_dir
    "visualize": {
        "effnet_distillation": {
            "save_dir": "./postprocess/distillation_outputs",
            "every_n_epochs": 1, "max_samples": 1},
    },
}


def group(name: str, option: str) -> Config:
    """A fresh copy of one group option."""
    try:
        return Config(copy.deepcopy(GROUPS[name][option]))
    except KeyError:
        raise ValueError(f"Unknown option {option!r} of config group "
                         f"{name!r} (available: {sorted(GROUPS.get(name, {}))})"
                         ) from None


def compose(root: str, overrides: Iterable[str] = (),
            group_overrides: Mapping[str, str] | None = None) -> Config:
    """The root's ``defaults`` (each ``group: option`` nested under
    ``cfg[group]``, a CLI selection replacing the option), its own keys at
    ``_self_``, the selected groups the root does not name, then the dotted
    overrides."""
    group_overrides = dict(group_overrides or {})
    raw = copy.deepcopy(ROOTS[root])
    merged = Config()
    self_merged = False
    for entry in raw.pop("defaults", []):
        if entry == "_self_":
            merged = deep_merge(merged, raw)
            self_merged = True
            continue
        (name, option), = entry.items()
        option = group_overrides.get(name, option)
        merged = deep_merge(merged, Config({name: group(name, option)}))
    if not self_merged:
        merged = deep_merge(merged, raw)
    for name, option in group_overrides.items():
        if name not in merged:
            merged[name] = group(name, option)
    return apply_overrides(merged, overrides)


def compose_cli(root: str, argv: Iterable[str]) -> Config:
    """Bare ``group=option`` args select group options; dotted args are
    value overrides; a bare key that is no group must be ``+key=...``."""
    groups, dotted = {}, []
    for ov in argv:
        key, _, val = ov.partition("=")
        bare = key.lstrip("+")
        if "." not in key and bare in GROUPS:
            groups[bare] = val
        else:
            if "." not in key and not key.startswith("+"):
                raise ValueError(
                    f"Unknown config group {key!r} (available: "
                    f"{sorted(GROUPS)}); use +{key}=... to set a new "
                    "top-level value"
                )
            dotted.append(ov)
    return compose(root, dotted, group_overrides=groups)
