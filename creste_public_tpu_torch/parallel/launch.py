"""Starting the ranks of a data-parallel run.

A training command asks for ``trainer.devices`` cards. Under ``torchrun``
(``RANK`` and ``WORLD_SIZE`` set) every process joins the launch's group
(``join_launch``). Otherwise a command that asks for more than one card
starts one process per card itself (``spawn``), so that the JAX package's
command line, ``python -m creste_public_tpu_torch.train_ssc
trainer.devices=2``, keeps working.
"""
from __future__ import annotations

import os
import shutil
import tempfile
from typing import Any, Callable

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from creste_public_tpu_torch.parallel.mesh import backend_for, launched_world


def requested_devices(tcfg: Any) -> int:
    """The cards a run asks for: ``trainer.devices``, where ``None`` means
    every card of the launch: the launch's world size under ``torchrun``,
    else every visible card on CUDA, one CPU process on the CPU."""
    n = tcfg.get("devices", None)
    if n is not None:
        return int(n)
    if "WORLD_SIZE" in os.environ or dist.is_initialized():
        return launched_world()
    if torch.device(tcfg.get("device", "cuda")).type == "cuda":
        return max(1, torch.cuda.device_count())
    return 1


def join_launch(device: str | torch.device) -> bool:
    """Join the group of a ``torchrun`` launch (``env://``, the backend of
    the device) unless it is joined already or this process was not
    launched so. True when this call made the group (the caller then
    destroys it)."""
    if dist.is_initialized() or "RANK" not in os.environ:
        return False
    dist.init_process_group(backend_for(device), init_method="env://")
    return True


def _rank_main(rank: int, world: int, init_file: str, device: str,
               fn: Callable, args: tuple, backend: str | None) -> None:
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world))
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(rank if backend is None
                              else rank % torch.cuda.device_count())
    else:  # the ranks share the host's cores
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    dist.init_process_group(backend or backend_for(device),
                            init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, device: str | torch.device,
          *args, backend: str | None = None) -> None:
    """Run ``fn(*args)`` in ``world`` new processes (spawned, not
    daemonic, so that a rank may start its own loader processes), each
    rank ``r`` in one group (``LOCAL_RANK`` = ``r``, a file rendezvous in
    a fresh temporary directory); returns when every rank has ended, and
    raises if one failed. On CUDA rank ``r`` takes card ``r``; with a
    ``backend`` in place of the device's, card ``r`` modulo the cards
    there are (``gloo`` puts several ranks on one card, which NCCL
    refuses)."""
    tmp = tempfile.mkdtemp(prefix="creste_ranks_")
    try:
        mp.start_processes(
            _rank_main, args=(world, os.path.join(tmp, "rendezvous"),
                              str(device), fn, args, backend),
            nprocs=world, join=True, daemon=False, start_method="spawn")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
