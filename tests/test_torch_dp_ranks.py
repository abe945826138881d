"""Shared harness of the data-parallel tests (no tests of its own, and no
JAX: spawned ranks import this module).

``run_ranks(fn, world, out_dir, *args)`` runs ``fn(rank, *args)`` in
``world`` spawned CPU processes joined in one gloo group (the port's
``parallel.launch.spawn``, torch on one thread per rank) and returns each
rank's result. ``dp_step`` is one rank's data-parallel training step with
fed drop-connect masks and SupCon priorities; ``serial_emulation`` is the
same step emulated in one process: every rank's rows through the same loss
closure in one graph, the SupCon anchors of each rank contrasted with the
features of all of them, the mean of the ranks' losses differentiated, one
Adam step, and the running statistics the mean of each rank's.
"""
from __future__ import annotations

import contextlib
import os

import numpy as np
import torch
import torch.distributed as dist

from creste_public_tpu_torch.losses import manager
from creste_public_tpu_torch.models.blocks.convnets import (
    BatchNorm,
    discard_batch_stats,
)
from creste_public_tpu_torch.ops import splat
from creste_public_tpu_torch.parallel import launch, shard_batch
from creste_public_tpu_torch.training import pipelines
from creste_public_tpu_torch.training.loop import to_device
from creste_public_tpu_torch.training.state import global_norm
from creste_public_tpu_torch.utils import depth, geometry

CPU = torch.device("cpu")


def _rank_entry(fn, out_dir: str, args: tuple) -> None:
    torch.set_num_threads(1)
    r = dist.get_rank()
    torch.save(fn(r, *args), os.path.join(out_dir, f"rank{r}.pt"))


def run_ranks(fn, world: int, out_dir, *args) -> list:
    """``fn(rank, *args)`` of each of ``world`` spawned gloo ranks."""
    os.makedirs(out_dir, exist_ok=True)
    launch.spawn(_rank_entry, world, "cpu", fn, str(out_dir), args)
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


class Feeder:
    """Fed drop-connect masks [b, 1, 1, 1], in call order."""

    def __init__(self, masks, dtype=torch.float32):
        self.masks, self.calls, self.dtype = masks, 0, dtype

    def __call__(self, batch, keep):
        m = self.masks[self.calls % len(self.masks)]
        self.calls += 1
        assert m.shape == (batch, 1, 1, 1), (m.shape, batch)
        return torch.from_numpy(np.asarray(m)).to(self.dtype)


def make_masks(n: int, batch: int, seed: int) -> list[np.ndarray]:
    """``n`` drop-connect masks [batch, 1, 1, 1] with a zero in the first
    and in the middle one."""
    rng = np.random.default_rng(seed)
    masks = [rng.uniform(size=(batch, 1, 1, 1)) > 0.3 for _ in range(n)]
    masks[0][-1] = masks[n // 2][0] = False
    return masks


def build(stage: str, cfg: dict, weights: dict, steps_per_epoch: int = 2,
          device: torch.device = CPU):
    """(model, loss manager, state) on ``device`` with ``weights``
    loaded."""
    model, lm, state = pipelines.init_stage(
        stage, cfg, steps_per_epoch=steps_per_epoch, device=device)
    model.load_state_dict(weights, strict=True)
    return model, lm, state


def grads_of(model) -> dict[str, torch.Tensor]:
    return {k: p.grad.detach().clone() for k, p in model.named_parameters()
            if p.grad is not None}


def dp_step(rank: int, stage: str, cfg: dict, weights: dict, batch: dict,
            masks: list, priorities: list, task: str | None) -> dict:
    """One data-parallel step of ``stage`` on this rank's rows of the
    global ``batch`` with its masks and SupCon priorities: the reduced
    gradients, the state after the step and the metrics."""
    world = dist.get_world_size()
    group = dist.group.WORLD
    model, lm, state = build(stage, cfg, weights)
    step = pipelines.make_train_step(stage, model, lm, task=task,
                                     group=group)
    rows = to_device(shard_batch(batch, rank, world), CPU)
    pri = (torch.from_numpy(priorities[rank]) if priorities is not None
           else None)
    metrics = step(state, rows, Feeder(masks[rank]), priorities=pri)
    return dict(grads=grads_of(model), state=model.state_dict(),
                metrics={k: float(v) for k, v in metrics.items()},
                step=state.step)


def dp_steps(rank: int, cases: list[dict]) -> list[dict]:
    """``dp_step`` of each case (a dict of its arguments)."""
    return [dp_step(rank, c["stage"], c["cfg"], c["weights"], c["batch"],
                    c["masks"], c["pri"], c["task"]) for c in cases]


def serial_emulation(stage: str, cfg: dict, weights: dict, batch: dict,
                     masks: list, priorities: list, task: str | None,
                     world: int, device: torch.device = CPU) -> dict:
    """The step of ``dp_step`` over ``world`` ranks, emulated in one
    process on ``device`` (see the module docstring)."""
    model, lm, state = build(stage, cfg, weights, device=device)
    closure = pipelines.make_loss_closure(stage, model, lm, task)
    model.train()
    model.zero_grad(set_to_none=True)
    recorded: list[dict] = []
    real = manager.multi_pos_con_loss

    def record(feats, labels, valid, temperature=0.1, class_weights=None,
               group=None):
        # SupCon's inputs of this rank; its loss enters below, over the
        # features of every rank
        zero = torch.zeros((), device=feats.device, requires_grad=True)
        recorded.append(dict(feats=feats, labels=labels, valid=valid,
                             temperature=temperature,
                             class_weights=class_weights, zero=zero))
        return zero

    totals, metrics, staged = [], [], []
    manager.multi_pos_con_loss = record
    try:
        for r in range(world):
            discard_batch_stats(model)
            rows = to_device(shard_batch(batch, r, world), device)
            pri = (torch.from_numpy(priorities[r]) if priorities is not None
                   else None)
            total, m = closure(rows, Feeder(masks[r]), priorities=pri)
            totals.append(total)
            metrics.append(m)
            staged.append({name: tuple(t.detach().clone() for t in bn.staged)
                           for name, bn in model.named_modules()
                           if isinstance(bn, BatchNorm)
                           and bn.staged is not None})
    finally:
        manager.multi_pos_con_loss = real
    discard_batch_stats(model)
    # each rank's loss: SupCon's anchors (normalised once, as in the loss)
    # against every rank's features, as leaves whose gradients add up over
    # the ranks as the gather's backward adds them
    roots = [[t] for t in totals]
    supcon = {}
    if recorded:
        assert len(recorded) == world
        anchors = [_normalised(rec["feats"]) for rec in recorded]
        cots = []
        for r, rec in enumerate(recorded):
            leaves = [a.detach().requires_grad_() for a in anchors]
            loss_r = _supcon_against(rec, anchors[r], torch.cat(leaves), r,
                                     torch.cat([q["labels"] for q in recorded]),
                                     torch.cat([q["valid"] for q in recorded]))
            (coef,) = torch.autograd.grad(totals[r], rec["zero"],
                                          retain_graph=True)
            roots[r] = [totals[r] + coef * loss_r]
            cots.append(torch.autograd.grad(roots[r][0], leaves,
                                            retain_graph=True))
            supcon[r] = (float(coef), float(loss_r.detach()))
        for r in range(world):
            roots[r].append(anchors[r])
            roots[r].append(sum(c[r] for c in cots))
    # each rank's gradient, then their mean
    rank_grads = []
    for r in range(world):
        model.zero_grad(set_to_none=True)
        if len(roots[r]) == 1:
            roots[r][0].backward()
        else:
            torch.autograd.backward(
                roots[r][:2], [torch.ones((), device=device), roots[r][2]])
        rank_grads.append(grads_of(model))
    loss = sum(rt[0].detach() for rt in roots) / world
    for k, p in model.named_parameters():
        if k in rank_grads[0]:
            p.grad = sum(g[k] for g in rank_grads) / world
    opt = state.optimizer
    for group in opt.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
    grads = grads_of(model)
    opt.step()
    state.scheduler.step()
    with torch.no_grad():
        for name, bn in model.named_modules():
            if name in staged[0]:
                bn.running_mean.copy_(sum(s[name][0] for s in staged) / world)
                bn.running_var.copy_(sum(s[name][1] for s in staged) / world)
    mean_m = {k: sum(float(m[k].detach()) for m in metrics) / world
              for k in metrics[0]}
    mean_m["loss"] = float(loss)
    mean_m["grad_norm"] = float(global_norm(list(grads.values())))
    return dict(grads=grads, state=model.state_dict(), metrics=mean_m,
                supcon=supcon)


def _normalised(feats):
    return feats * torch.rsqrt((feats * feats).sum(-1, keepdim=True)
                               + 1e-12)


def _supcon_against(rec: dict, feats, all_feats, r: int, all_labels,
                    all_valid) -> torch.Tensor:
    """Rank r's SupCon loss with its (normalised) anchors ``feats``
    against every rank's features, written out from the single-device
    definition."""
    labels, valid = rec["labels"], rec["valid"]
    M = feats.shape[0]
    logits_mask = torch.ones(M, all_feats.shape[0], device=feats.device)
    idx = torch.arange(M, device=feats.device)
    logits_mask[idx, idx + r * M] = 0.0
    pair_valid = valid[:, None] & all_valid[None, :]
    mask = ((labels[:, None] == all_labels[None, :]).float() * logits_mask
            * pair_valid)
    logits = feats @ all_feats.T / rec["temperature"]
    logits = logits - (1.0 - logits_mask) * 1e9
    logits = logits - (~pair_valid).float() * 1e9
    logits = logits - logits.max(dim=-1, keepdim=True).values.detach()
    p = mask / torch.clamp(mask.sum(-1, keepdim=True), min=1.0)
    per_anchor = (p * torch.log_softmax(logits, dim=-1)).sum(-1)
    cw = rec["class_weights"]
    if cw is not None:
        per_anchor = per_anchor * cw[torch.clamp(labels, 0, cw.shape[0] - 1)]
    per_anchor = per_anchor * valid
    return -per_anchor.sum() / torch.clamp(valid.sum(), min=1.0)


def supcon_ranks(rank: int, cases: list[dict]) -> list[dict]:
    """Each case's ``multi_pos_con_loss`` on this rank's rows, gathered
    over the group: the loss and the gradient of this rank's features."""
    from creste_public_tpu_torch.losses.supcon import multi_pos_con_loss

    world = dist.get_world_size()
    out = []
    for c in cases:
        rows = shard_batch({k: c[k] for k in ("feats", "labels", "valid")},
                           rank, world)
        feats = torch.from_numpy(rows["feats"]).requires_grad_()
        cw = c.get("class_weights")
        loss = multi_pos_con_loss(
            feats, torch.from_numpy(rows["labels"]),
            torch.from_numpy(rows["valid"]), 0.1,
            class_weights=None if cw is None else torch.from_numpy(cw),
            group=dist.group.WORLD)
        loss.backward()
        out.append(dict(loss=float(loss.detach()), grad=feats.grad.numpy()))
    return out


def dp_temporal_step(rank: int, cfg: dict, weights: dict, chunk: dict,
                     hidden: list, priorities: list, noise: list) -> dict:
    """One data-parallel chunk step at the start of the sequences (``bos``)
    on this rank's rows, with its SupCon priorities and pose noise: the
    reduced gradients, the state, the metrics and this rank's new hidden
    state."""
    world = dist.get_world_size()
    model, lm, state = build("ssc", cfg, weights)
    step = pipelines.make_temporal_train_step(model, lm, task="joint",
                                              group=dist.group.WORLD)
    rows = to_device(shard_batch(chunk, rank, world), CPU)
    h = [tuple(torch.from_numpy(a) for a in
               shard_batch({str(i): a for i, a in enumerate(layer)},
                           rank, world).values()) for layer in hidden]
    _, metrics, new_hidden = step(
        state, rows, h, True, None,
        priorities=torch.from_numpy(priorities[rank]),
        pose_noise=[tuple(torch.from_numpy(a) for a in noise[rank])])
    return dict(grads=grads_of(model), state=model.state_dict(),
                metrics={k: float(v) for k, v in metrics.items()},
                hidden=[tuple(a.numpy() for a in layer)
                        for layer in new_hidden])


def dp_cases(rank: int, steps: list[dict], temporal: dict,
             f64: dict) -> dict:
    """``dp_steps`` of ``steps``, ``dp_temporal_step`` of ``temporal`` (a
    dict of its arguments) and ``dp_f64_grads`` of ``f64``, in one
    spawn."""
    return dict(steps=dp_steps(rank, steps),
                temporal=dp_temporal_step(rank, **temporal),
                f64=dp_f64_grads(rank, f64))


def f64_forward(bn):
    """The port's train-mode BatchNorm without its cast to f32 (the
    statistics are not staged: an f64 step is read for its gradient)."""
    def forward(x):
        dims = [0, *range(2, x.dim())]
        mean = x.mean(dims)
        var = torch.clamp((x * x).mean(dims) - mean * mean, min=0.0)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        mul = torch.rsqrt(var + bn.eps) * bn.weight
        return (x - mean.view(shape)) * mul.view(shape) + bn.bias.view(shape)
    return forward


class _TorchF64:
    """``torch`` for a port module whose f32 dtypes are lifted to f64."""

    def __init__(self, torch_):
        self._torch = torch_

    def __getattr__(self, name):
        return getattr(self._torch, "float64" if name == "float32" else name)


@contextlib.contextmanager
def lift_f32():
    """The port's f32 islands lifted to f64, as the JAX side's ``LiftF32``
    lifts JAX's (tests/test_torch_dp_jax_step.py): the backprojection
    (utils/geometry.py), the depth expectation (utils/depth.py) and the
    splat (ops/splat.py) cast with ``.float()``, name ``torch.float32`` and
    allocate in the default dtype. Left in f32, the depth expectation's bin
    values and the backprojection round on one side and not on the other,
    and the two f64 gradients part by ~1e-3."""
    to_f32 = torch.Tensor.float
    dtype = torch.get_default_dtype()
    mods = (geometry, depth, splat)
    torch.Tensor.float = lambda t, *a, **k: (
        t if t.dtype == torch.float64 else to_f32(t, *a, **k))
    torch.set_default_dtype(torch.float64)
    for m in mods:
        m.torch = _TorchF64(torch)
    try:
        yield
    finally:
        torch.Tensor.float = to_f32
        torch.set_default_dtype(dtype)
        for m in mods:
            m.torch = torch


def f64_grads(stage: str, cfg: dict, weights: dict, rows: dict, masks: list,
              pri, task: str | None, group=None) -> dict:
    """The gradient of one step in f64 (every BatchNorm and every f32
    island in f64), reduced over ``group``: the model's, with its batch in
    f64."""
    model, lm, state = build(stage, cfg, weights)
    model.double()
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.forward = f64_forward(m)
    rows = _double(to_device(rows, CPU))
    step = pipelines.make_train_step(stage, model, lm, task=task,
                                     group=group)
    with lift_f32():
        step(state, rows, Feeder(masks, torch.float64),
             priorities=None if pri is None else torch.from_numpy(pri))
    return grads_of(model)


def dp_f64_grads(rank: int, c: dict) -> dict:
    """``f64_grads`` of this rank's rows, reduced over the ranks."""
    world = dist.get_world_size()
    return f64_grads(c["stage"], c["cfg"], c["weights"],
                     shard_batch(c["batch"], rank, world), c["masks"][rank],
                     None if c["pri"] is None else c["pri"][rank], c["task"],
                     dist.group.WORLD)


def _double(batch: dict) -> dict:
    return {k: _double(v) if isinstance(v, dict)
            else v.double() if v.is_floating_point() else v
            for k, v in batch.items()}
