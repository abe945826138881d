"""CLI harness of the port's training entry points.

Counterpart of ``creste_public_tpu/cli.py``: ``python -m
creste_public_tpu_torch.train_ssc trainer=smoke model.batch_size=4 ...``
(or ``train_depth``, ``train_pefree``, ``train_traversability``) composes
the stage's root config from the plain-dict groups of ``config.groups``
(group selections + dotted overrides) and runs the stage's training loop
on the synthetic dataset. The port has no ``JAX_PLATFORMS``:
``trainer.device`` (default ``cuda``) picks the device, and
``trainer.device=cpu`` runs on the CPU.
"""
from __future__ import annotations

import sys

from creste_public_tpu_torch.config.config import Config
from creste_public_tpu_torch.config.groups import compose_cli
from creste_public_tpu_torch.data.dataloader import EpochLoader, build_dataset
from creste_public_tpu_torch.training.loop import run_training
from creste_public_tpu_torch.training.optim import LOAD_SETTING_FROZEN
from creste_public_tpu_torch.training.state import TrainState


def launch(root: str, argv: list[str] | None = None) -> TrainState:
    argv = sys.argv[1:] if argv is None else argv
    return train_from_config(compose_cli(root, argv))


def train_from_config(cfg: Config) -> TrainState:
    stage = cfg["stage"]
    model_cfg = Config(cfg["model"])
    ds_cfg = Config(cfg["dataset"])
    tcfg = Config(cfg["trainer"])
    task = cfg.get("task", None)
    if "tasks" in ds_cfg:
        raise NotImplementedError("multi-task datasets are not ported yet")
    if ds_cfg.get("do_augmentation", False):
        raise NotImplementedError("augmentation is not ported yet")

    batch = int(model_cfg.get("batch_size", 4))
    workers = int(tcfg.get("num_workers", 4))
    worker_mode = str(tcfg.get("loader_worker_mode", "thread"))
    train_ds = build_dataset(ds_cfg, "train")
    val_ds = build_dataset(ds_cfg, "val")
    train_loader = EpochLoader(train_ds, batch, shuffle=True,
                               seed=int(tcfg.get("seed", 0)),
                               num_workers=workers, worker_mode=worker_mode)
    val_loader = EpochLoader(val_ds, batch, shuffle=False, drop_last=False,
                             num_workers=workers, worker_mode=worker_mode)
    if len(train_loader) == 0:
        raise ValueError(
            f"train loader yields no batches: batch_size={batch} > "
            f"dataset length {len(train_ds)} with drop_last — lower "
            "model.batch_size or enlarge the dataset/split"
        )
    tcfg["steps_per_epoch"] = max(len(train_loader), 1)

    load_weights = None
    load_setting = model_cfg.get("load_setting", "strict")
    weights_path = model_cfg.get("weights_path", "") or cfg.get(
        "weights_path", "")
    if weights_path:
        from creste_public_tpu_torch.training.surgery import make_stage_loader

        load_weights = make_stage_loader(stage, weights_path, load_setting)

    if stage == "traversability":
        # lfd.py:81-90 of the reference freezes the backbone whatever the
        # load setting
        frozen_pred = lambda p: p.startswith("backbone")  # noqa: E731
    else:
        frozen_pred = LOAD_SETTING_FROZEN.get(load_setting)

    return run_training(
        stage, model_cfg, train_loader.epoch, lambda: val_loader.epoch(0),
        trainer_cfg=tcfg, task=task, load_weights=load_weights,
        frozen_pred=frozen_pred)
