"""CLI harness of the port's training entry points.

Counterpart of ``creste_public_tpu/cli.py``: ``python -m
creste_public_tpu_torch.train_ssc trainer=smoke model.batch_size=4 ...``
(or ``train_depth``, ``train_pefree``, ``train_traversability``) composes
the stage's root config from the plain-dict groups of ``config.groups``
(group selections + dotted overrides) and runs the stage's training loop
on the synthetic or the CODa dataset: one dataset, or with
``dataset.tasks`` several named ones cycled to the longest
(``MultiTaskIterator``), augmented with ``dataset.do_augmentation``. The port has no ``JAX_PLATFORMS``:
``trainer.device`` (default ``cuda``) picks the device, and
``trainer.device=cpu`` runs on the CPU. ``dataset=coda dataset.root=DIR``
reads a UT CODa directory tree (``data.coda_dataset``), its frames
decoded on ``trainer.device`` (nvJPEG and a kernel on a rank's card; PIL
with ``trainer.device=cpu``; process-mode loader workers refuse the
card), and
``visualize=effnet_distillation`` writes the validation images as PNGs
under ``visualize.save_dir``.

``trainer.devices=N`` trains data-parallel on N cards (``null``: every card
of the launch): the command starts one process per card itself, or, under
``torchrun``, joins the launch's group (``parallel.launch``). A command
that starts its ranks returns None; the ranks' state is in the
checkpoints.
"""
from __future__ import annotations

import sys

import torch.distributed as dist

from creste_public_tpu_torch.config.config import Config
from creste_public_tpu_torch.config.groups import compose_cli
from creste_public_tpu_torch.data.dataloader import (
    EpochLoader,
    MultiTaskIterator,
    build_dataset,
)
from creste_public_tpu_torch.parallel import launch as pl
from creste_public_tpu_torch.parallel.mesh import rank_device
from creste_public_tpu_torch.training.loop import run_training
from creste_public_tpu_torch.training.optim import LOAD_SETTING_FROZEN
from creste_public_tpu_torch.training.state import TrainState
from creste_public_tpu_torch.utils.device import resolve_device


def launch(root: str, argv: list[str] | None = None) -> TrainState | None:
    argv = sys.argv[1:] if argv is None else argv
    return train_from_config(compose_cli(root, argv))


def train_from_config(cfg: Config) -> TrainState | None:
    """Train ``cfg``: in this process, in the ``torchrun`` group it was
    launched in, or, when ``trainer.devices`` asks for more than one card
    outside a launch, in as many spawned ranks (then None)."""
    tcfg = Config(cfg["trainer"])
    device = tcfg.get("device", "cuda")
    made = pl.join_launch(device)
    world = pl.requested_devices(tcfg)
    if not dist.is_initialized() and world > 1:
        pl.spawn(train_from_config, world, device, cfg)
        return None
    try:
        return _train(cfg)
    finally:
        if made:
            dist.destroy_process_group()


def _train(cfg: Config) -> TrainState:
    stage = cfg["stage"]
    model_cfg = Config(cfg["model"])
    ds_cfg = Config(cfg["dataset"])
    tcfg = Config(cfg["trainer"])
    task = cfg.get("task", None)
    rank, world = ((dist.get_rank(), dist.get_world_size())
                   if dist.is_initialized() else (0, 1))
    # the optional visualize group (reference configs/visualize/*) turns on
    # the validation images (training/visual_log.py)
    if "visualize" in cfg:
        vz = Config(cfg["visualize"])
        tcfg["log_val_images"] = True
        if vz.get("save_dir"):
            tcfg["visuals_dir"] = vz["save_dir"]

    # the CODa reader decodes on the rank's card (or the CPU)
    reader_device = resolve_device(tcfg.get("device", "cuda"))
    if world > 1:
        reader_device = rank_device(reader_device)
    batch = int(model_cfg.get("batch_size", 4))
    workers = int(tcfg.get("num_workers", 4))
    worker_mode = str(tcfg.get("loader_worker_mode", "thread"))
    transform = None
    if ds_cfg.get("do_augmentation", False):
        from creste_public_tpu_torch.data.augment import augment_sample

        transform = augment_sample

    def train_loader(sub: Config) -> EpochLoader:
        return EpochLoader(build_dataset(sub, "train", reader_device), batch,
                           shuffle=True,
                           seed=int(tcfg.get("seed", 0)),
                           transform=transform, num_workers=workers,
                           worker_mode=worker_mode, rank=rank,
                           world_size=world)

    def val_loader(sub: Config) -> EpochLoader:
        return EpochLoader(build_dataset(sub, "val", reader_device), batch,
                           shuffle=False,
                           drop_last=False, num_workers=workers,
                           worker_mode=worker_mode, rank=rank,
                           world_size=world)

    if "tasks" in ds_cfg:
        # named task datasets cycled to the longest (the reference's
        # CombinedLoader, dataloader.py:352-368); validation on the first
        # task's split
        loaders = {name: train_loader(Config(sub))
                   for name, sub in ds_cfg["tasks"].items()}
        train_factory = MultiTaskIterator(loaders).epoch
        val = val_loader(Config(next(iter(ds_cfg["tasks"].values()))))
        tcfg["steps_per_epoch"] = max(
            max(len(ld) for ld in loaders.values()) * len(loaders), 1)
    else:
        loaders = {None: train_loader(ds_cfg)}
        train_factory = loaders[None].epoch
        val = val_loader(ds_cfg)
        if len(loaders[None]) == 0:
            raise ValueError(
                f"train loader yields no batches: batch_size={batch} > "
                f"dataset length {len(loaders[None].dataset)} with "
                "drop_last — lower model.batch_size or enlarge the "
                "dataset/split"
            )
        tcfg["steps_per_epoch"] = max(len(loaders[None]), 1)

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

    try:
        return run_training(
            stage, model_cfg, train_factory, lambda: val.epoch(0),
            trainer_cfg=tcfg, task=task, load_weights=load_weights,
            frozen_pred=frozen_pred)
    finally:
        for ld in [*loaders.values(), val]:
            ld.close()
