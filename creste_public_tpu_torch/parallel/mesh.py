"""Data-parallel helpers over ``torch.distributed``.

Counterpart of ``creste_public_tpu/parallel/mesh.py``'s data axis
(``make_mesh``, ``shard_batch``, ``replicate``) and of the collectives of
the JAX package's ``shard_map`` step: one process per card (rank ``r`` of
``world`` on ``cuda:LOCAL_RANK``), each holding the whole state and the
rows ``[r * b, (r + 1) * b)`` of every global batch of ``world * b`` rows.
A group of ``None`` means no data parallelism: every helper is then the
identity, so single-device code paths run no collective.

The backend follows the device: NCCL for CUDA ranks, gloo for CPU ones
(``backend_for``).
"""
from __future__ import annotations

import os
from typing import Any, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

Group = Any  # a torch.distributed ProcessGroup, or None: no data parallelism


def backend_for(device: str | torch.device) -> str:
    """``nccl`` for a CUDA device, ``gloo`` for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def launched_world() -> int:
    """The world size of the process group this process belongs to, or of
    the launch it was started by (``WORLD_SIZE``, as ``torchrun`` sets it)
    when the group is not made yet; 1 outside any launch."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", 1))


def rank(group: Group = None) -> int:
    """This process's rank in ``group`` (0 without one)."""
    return dist.get_rank(group) if group is not None else 0


def world_size(group: Group = None) -> int:
    """The number of ranks of ``group`` (1 without one)."""
    return dist.get_world_size(group) if group is not None else 1


def rank_device(device: str | torch.device) -> torch.device:
    """The device of this rank: ``cuda:LOCAL_RANK`` for a CUDA run (made
    the current device), the CPU for a CPU run."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    torch.cuda.set_device(dev)
    return dev


def pad_to_multiple(batch: dict, multiple: int) -> dict:
    """Pad the leading axis so it divides the ranks (the last partial
    batch), repeating the batch's own rows from the start (wrap-repeat, as
    the JAX loop's ``_pad_to_multiple``)."""
    def pad(x):
        if isinstance(x, dict):
            return {k: pad(v) for k, v in x.items()}
        if not hasattr(x, "shape") or x.ndim == 0:
            return x
        b = x.shape[0]
        if b % multiple == 0:
            return x
        target = -(-b // multiple) * multiple
        idx = np.arange(target) % b  # wrap-repeat samples
        return np.asarray(x)[idx]

    return {k: pad(v) for k, v in batch.items()}


def shard_batch(batch: dict, rank_: int, world: int) -> dict:
    """The rows of rank ``rank_`` of a global batch whose leading axis
    ``world`` divides (``pad_to_multiple`` first): what JAX's
    ``shard_batch`` places on the ``rank_``-th device of the data mesh."""
    def rows(x):
        if isinstance(x, dict):
            return {k: rows(v) for k, v in x.items()}
        if not hasattr(x, "shape") or x.ndim == 0:
            return x
        if x.shape[0] % world:
            raise ValueError(f"a leading axis of {x.shape[0]} rows does not "
                             f"split over {world} ranks")
        n = x.shape[0] // world
        return x[rank_ * n:(rank_ + 1) * n]

    return {k: rows(v) for k, v in batch.items()}


def all_reduce_mean(tensors: Sequence[torch.Tensor], group: Group) -> None:
    """Replace each tensor (in place) by its mean over the ranks of
    ``group``: one all-reduce of a flat buffer per dtype (the sum, then a
    division by the world size, as ``lax.pmean``). No-op without a
    group."""
    if group is None or not tensors:
        return
    world = dist.get_world_size(group)
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, group=group)
        flat /= world
        offset = 0
        for t in ts:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def broadcast_module(module: nn.Module, group: Group, src: int = 0) -> None:
    """Every parameter and buffer of ``module`` set to rank ``src``'s (the
    JAX package's ``replicate`` of the state). No-op without a group."""
    if group is None:
        return
    with torch.no_grad():
        for t in [*module.parameters(), *module.buffers()]:
            dist.broadcast(t.data, src=dist.get_global_rank(group, src),
                           group=group)


class _GatherWithGrad(torch.autograd.Function):
    """``all_gather`` of [M, ...] into [world * M, ...] whose backward is
    JAX's transpose of ``lax.all_gather``: the incoming gradient summed
    over the ranks, of which this rank keeps its own slice."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        ctx.rows = x.shape[0]
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        r = dist.get_rank(ctx.group)
        return grad[r * ctx.rows:(r + 1) * ctx.rows], None


def all_gather_with_grad(x: torch.Tensor, group: Group) -> torch.Tensor:
    """[M, ...] of every rank, concatenated in rank order, with a gradient
    back to each rank's rows (``lax.all_gather`` then a reshape)."""
    return _GatherWithGrad.apply(x, group)


def all_gather_rows(x: torch.Tensor, group: Group) -> torch.Tensor:
    """[M, ...] of every rank concatenated in rank order, without a
    gradient (labels, validity; gloo has no bool, so a mask travels as
    uint8)."""
    y = x.detach().contiguous()
    y = y.to(torch.uint8) if x.dtype == torch.bool else y
    parts = [torch.empty_like(y) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, y, group=group)
    return torch.cat(parts).to(x.dtype)
