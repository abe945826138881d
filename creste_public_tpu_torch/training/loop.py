"""Training loop: epochs, validation, checkpoints, metrics log, profiling.

Counterpart of ``creste_public_tpu/training/loop.py``. The loop moves each
host batch to the device, runs the stage's training step with a generator
derived from ``(seed, step, rank)`` (the drop-connect masks, then stage
2's SupCon priorities), logs every
``log_every_n_steps`` steps and once per epoch to ``ckpt_dir/
metrics.jsonl`` (the JAX loop's keys), validates in eval mode every
``check_val_every_n_epoch`` epochs, keeps the top-k checkpoints by
``monitor_metric``, saves every ``ckpt_every_n_steps`` steps and at the
end, and traces ``profile_steps`` steps from ``profile_start`` with
``torch.profiler`` when ``profile_dir`` is set.

With ``freeze_backbone_epochs`` > 0 (stage 2) each batch carries the gate
``_backbone_unfrozen`` = ``epoch >= freeze_backbone_epochs``, by which the
step multiplies the backbone's gradients (``pipelines.backbone_freeze_gate``).

Resume (``resume=true``) is position-faithful, as in the JAX loop: the
epoch and the batches to skip in it follow from the restored step (the
loaders shuffle with a per-epoch seed), and the per-step generator depends
only on ``(seed, step, rank)``, so a resumed run replays the batch order and the
drop-connect masks of an uninterrupted one.

Items of ``(task, batch)`` (``data.dataloader.MultiTaskIterator``) take
one step each with that task's losses (a step function per task).

Data parallelism: ``trainer.devices`` ranks (``None``: the launch's world
size), one process each in a ``torch.distributed`` group
(``parallel.launch``). Each rank's data yields its rows of every global
batch (``EpochLoader(rank=, world_size=)``; validation batches padded by
``pad_to_multiple``); the state is broadcast from rank 0 once after
init, graft and resume; the step means the gradients, the running
statistics and the metrics over the ranks, validation the metrics; only
rank 0 writes checkpoints and ``metrics.jsonl``. Validation images are not
ported yet and raise.
"""
from __future__ import annotations

import math
import os
import shutil
import time
import warnings
from collections import defaultdict
from typing import Any, Callable, Iterable

import numpy as np
import torch
import torch.distributed as dist

from creste_public_tpu_torch import parallel
from creste_public_tpu_torch.losses.manager import LossManager
from creste_public_tpu_torch.parallel import (
    Group,
    broadcast_module,
    launched_world,
    rank_device,
)
from creste_public_tpu_torch.training import checkpoint as ckpt
from creste_public_tpu_torch.training import pipelines
from creste_public_tpu_torch.training.state import TrainState, mean_metrics
from creste_public_tpu_torch.training.visual_log import log_visuals
from creste_public_tpu_torch.utils.device import resolve_device
from creste_public_tpu_torch.utils.logging import MetricLogger


class TopKCheckpoints:
    """Keeps the ``top_k`` checkpoints best by ``monitor`` (ModelCheckpoint
    equivalent, train_ssc.py:314-321 of the reference)."""

    def __init__(self, ckpt_dir: str, monitor: str, mode: str = "min",
                 top_k: int = 5):
        self.ckpt_dir = ckpt_dir
        self.monitor = monitor
        self.sign = 1.0 if mode == "min" else -1.0
        self.top_k = top_k
        self.saved: list[tuple[float, str]] = []

    def maybe_save(self, state: TrainState, step: int, metrics: dict) -> None:
        value = float(metrics.get(self.monitor, math.nan))
        if math.isnan(value):
            value = math.inf
        score = self.sign * value
        if self.top_k > 0 and len(self.saved) >= self.top_k:
            if score >= max(self.saved)[0]:
                return
        path = ckpt.save_checkpoint(self.ckpt_dir, step, state)
        self.saved.append((score, path))
        self.saved.sort()
        while self.top_k > 0 and len(self.saved) > self.top_k:
            _, stale = self.saved.pop()
            shutil.rmtree(stale, ignore_errors=True)


def step_generator(seed: int, step: int, rank: int = 0) -> torch.Generator:
    """The CPU generator of step ``step`` on rank ``rank``: its drop-connect
    masks, then its SupCon priorities. Rank 0's is the single-device one,
    each other rank draws its own (the JAX step's ``fold_in`` of the
    device index)."""
    entropy = (int(seed), int(step)) + ((int(rank),) if rank else ())
    state = np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state))


def data_parallel_group(tcfg: Any) -> Group:
    """The ranks' process group of a run that asks for
    ``trainer.devices`` cards (``None``: the launch's world size), or
    None for a single-device run outside any group. Raises when the
    process is not in a group of that many ranks."""
    have = launched_world() if dist.is_initialized() else 1
    want = tcfg.get("devices", None)
    want = have if want is None else int(want)
    if want != have:
        raise ValueError(
            f"trainer.devices={want} needs a process group of {want} ranks "
            f"and this process is in one of {have}: run the training command "
            f"with trainer.devices={want} (it starts one process per card), "
            f"or launch it with torchrun --nproc_per_node={want}")
    return dist.group.WORLD if dist.is_initialized() else None


def to_device(batch: dict, device: torch.device) -> dict:
    """A host batch (numpy arrays, nested dicts) as tensors on ``device``."""
    return {k: to_device(v, device) if isinstance(v, dict)
            else torch.as_tensor(v).to(device) for k, v in batch.items()}


# the seed of the validation's SupCon priorities: the JAX loop hands every
# validation batch the key PRNGKey(1)
EVAL_SEED = 1


def make_eval_step(stage: str, model, loss_manager: LossManager,
                   task: str | None = None,
                   group: Group = None) -> Callable[[dict], dict]:
    """eval_fn(batch) -> {name: float}: the model in eval mode, the losses
    (stage 3 with the penalty's eval-form ``reward_fn``, stage 2 with
    SupCon's priorities from a generator seeded ``EVAL_SEED`` for each
    batch, gathered over the ranks of ``group``), ``loss`` the sum of the
    weighted losses, then the scalar metadata; each the mean over the
    ranks."""

    def eval_fn(batch: dict) -> dict[str, float]:
        model.eval()
        with torch.no_grad():
            outputs = model(*pipelines.model_inputs(stage, batch))
        td = pipelines.merge_tensor_dict(batch, outputs, task)
        aux = pipelines.loss_aux(stage, model,
                                 torch.Generator().manual_seed(EVAL_SEED),
                                 group)
        loss_dict, meta = loss_manager(td, aux)
        metrics = {k: w * v for k, (w, v) in loss_dict.items()}
        metrics["loss"] = sum(metrics.values())
        metrics.update({k: v for k, v in meta.items() if v.ndim == 0})
        metrics = {k: v.detach() for k, v in metrics.items()}
        mean_metrics(metrics, group)
        return {k: float(v) for k, v in metrics.items()}

    return eval_fn


def run_validation(eval_fn: Callable[[dict], dict], batches: Iterable[dict],
                   device: torch.device) -> dict[str, float]:
    """The mean over ``batches`` of each metric of ``eval_fn``."""
    agg = defaultdict(list)
    for batch in batches:
        for k, v in eval_fn(to_device(batch, device)).items():
            agg[k].append(v)
    return {k: float(np.mean(v)) for k, v in agg.items()}


def run_training(
    stage: str,
    cfg: Any,
    train_data: Iterable | Callable[[int], Iterable],
    val_data: Callable[[], Iterable] | None = None,
    trainer_cfg: Any | None = None,
    task: str | None = None,
    load_weights: Callable[[TrainState], TrainState] | None = None,
    frozen_pred: Callable[[str], bool] | None = None,
) -> TrainState:
    """Train a stage on ``trainer_cfg["device"]`` (default ``"cuda"``;
    raises without a card unless ``"cpu"`` is asked for; each rank of a
    data-parallel run on ``cuda:LOCAL_RANK``). ``train_data`` is an
    iterable of host batches or of ``(task, batch)`` items, or an epoch ->
    iterable factory; under data parallelism it yields this rank's rows.
    Returns the final TrainState."""
    tcfg = trainer_cfg or {}
    dev = resolve_device(tcfg.get("device", "cuda"))
    group = data_parallel_group(tcfg)
    if group is not None:
        dev = rank_device(dev)
    rank = parallel.rank(group)
    max_epochs = int(tcfg.get("max_epochs", 1))
    max_steps = int(tcfg.get("max_steps", -1))
    log_every = int(tcfg.get("log_every_n_steps", 10))
    ckpt_dir = tcfg.get("ckpt_dir", "ckpts")
    val_every = int(tcfg.get("check_val_every_n_epoch", 1))
    seed = int(tcfg.get("seed", 0))
    freeze_epochs = int(tcfg.get("freeze_backbone_epochs", 0))

    factory = train_data if callable(train_data) else (lambda e: train_data)
    steps_per_epoch = tcfg.get("steps_per_epoch", None)
    if steps_per_epoch is None:
        # the LR decays per epoch by step counts, so a wrong default
        # silently changes the decay's cadence (the CLI always sets this)
        warnings.warn(
            "trainer.steps_per_epoch not set; defaulting to 100 — the "
            "ExponentialLR decay cadence will be wrong unless the real "
            "loader length is 100 steps/epoch",
            stacklevel=2,
        )
        steps_per_epoch = 100
    steps_per_epoch = int(steps_per_epoch)

    model, lm, state = pipelines.init_stage(
        stage, cfg, seed=seed, steps_per_epoch=steps_per_epoch,
        frozen_pred=frozen_pred, device=dev)
    if load_weights is not None:
        state = load_weights(state)
    # one step function per task: each computes only its task's losses
    step_fns: dict = {}

    def get_step(task_name):
        if task_name not in step_fns:
            step_fns[task_name] = pipelines.make_train_step(
                stage, model, lm, task=task_name,
                freeze_backbone_schedule=freeze_epochs > 0, group=group)
        return step_fns[task_name]

    eval_fn = make_eval_step(stage, model, lm, task=task, group=group)

    if tcfg.get("resume", False):
        if group is not None:
            dist.barrier(group)
        latest = ckpt.latest_checkpoint(ckpt_dir)
        if latest is not None:
            state = ckpt.restore_checkpoint(latest, state)
            print(f"resumed from {latest} (step {state.step})")
    # every rank starts from rank 0's parameters and statistics
    broadcast_module(model, group)
    start_step = state.step

    main_rank = rank == 0
    topk = TopKCheckpoints(
        ckpt_dir, tcfg.get("monitor_metric", "loss"),
        tcfg.get("monitor_mode", "min"), int(tcfg.get("save_top_k", 5)))
    logger = MetricLogger(
        os.path.join(ckpt_dir, "metrics.jsonl") if main_rank else None,
        stdout=main_rank and bool(tcfg.get("verbose", True)))
    ckpt_every = int(tcfg.get("ckpt_every_n_steps", 0))
    profile_dir = tcfg.get("profile_dir", None) if main_rank else None
    profile_start = int(tcfg.get("profile_start", 5))
    profile_steps = int(tcfg.get("profile_steps", 5))
    prof = None

    t0 = time.time()
    for epoch in range(start_step // steps_per_epoch, max_epochs):
        epoch_metrics = defaultdict(list)
        batches = iter(factory(epoch))
        if epoch == start_step // steps_per_epoch:
            # the batches of the resumed epoch already trained
            for _ in range(start_step % steps_per_epoch):
                next(batches, None)
        for item in batches:
            if isinstance(item, tuple) and isinstance(item[0], str):
                batch_task, batch = item
            else:
                batch_task, batch = task, item
            if freeze_epochs > 0:
                bsz = len(batch["image"])
                batch = dict(batch, _backbone_unfrozen=np.full(
                    (bsz,), float(epoch >= freeze_epochs), np.float32))
            if profile_dir and state.step == profile_start and prof is None:
                prof = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    *([torch.profiler.ProfilerActivity.CUDA]
                      if dev.type == "cuda" else [])])
                prof.start()
            metrics = get_step(batch_task)(
                state, to_device(batch, dev),
                step_generator(seed, state.step, rank))
            if main_rank and ckpt_every and state.step % ckpt_every == 0:
                ckpt.save_checkpoint(ckpt_dir, state.step, state)
            if prof is not None and (
                    state.step >= profile_start + profile_steps):
                _stop_profile(prof, profile_dir, dev)
                prof = None
                logger.log({"step": state.step, "profile_trace": profile_dir})
            if state.step % log_every == 0:
                host = {k: float(v) for k, v in metrics.items()}
                host.update(step=state.step, epoch=epoch,
                            wall_s=round(time.time() - t0, 1))
                logger.log(host)
            # kept on the device: the epoch summary reads them once
            for k, v in metrics.items():
                epoch_metrics[k].append(v)
            if 0 < max_steps <= state.step:
                break

        summary = {k: float(torch.stack(v).float().mean())
                   for k, v in epoch_metrics.items()}
        summary.update(step=state.step, epoch=epoch, split="train_epoch")
        logger.log(summary)

        if val_data is not None and (epoch + 1) % val_every == 0:
            val_batches = list(val_data())
            val_metrics = run_validation(eval_fn, val_batches, dev)
            val_metrics.update(step=state.step, epoch=epoch, split="val")
            logger.log(val_metrics)
            if main_rank and tcfg.get("log_val_images", False) and (
                    val_batches):
                vb = val_batches[0]
                vb = vb[1] if isinstance(vb, tuple) else vb
                log_visuals(stage, model, vb, logger, state.step,
                            out_dir=tcfg.get("visuals_dir", os.path.join(
                                ckpt_dir, "visuals")))
            if main_rank:
                topk.maybe_save(state, state.step, val_metrics)
        elif main_rank:
            topk.maybe_save(state, state.step, summary)
        if 0 < max_steps <= state.step:
            break

    if prof is not None:
        _stop_profile(prof, profile_dir, dev)
    if main_rank:
        ckpt.save_checkpoint(ckpt_dir, state.step, state)
    return state


def _stop_profile(prof, profile_dir: str, dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
