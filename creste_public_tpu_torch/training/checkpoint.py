"""Training checkpoints as torch files.

Counterpart of the save/restore half of
``creste_public_tpu/training/checkpoint.py``, in the same
``ckpt_dir/step_<n>`` layout: each step directory holds ``state.pt``, a
``torch.save`` of the step count, the model's state dict (parameters and
BatchNorm running statistics), the optimizer's and the LR scheduler's. The
port does not read the JAX package's orbax checkpoints: weights come over
from a flax variable tree through ``weights.from_jax_variables``.
"""
from __future__ import annotations

import os

import torch

from creste_public_tpu_torch.training.state import TrainState

STATE_FILE = "state.pt"


def save_checkpoint(ckpt_dir: str, step: int, state: TrainState) -> str:
    """Writes ``ckpt_dir/step_<step>/state.pt`` (through a temporary file,
    so a killed run leaves no half-written checkpoint); returns the step
    directory."""
    path = os.path.join(os.path.abspath(ckpt_dir), f"step_{step}")
    os.makedirs(path, exist_ok=True)
    target = os.path.join(path, STATE_FILE)
    torch.save({
        "step": int(state.step),
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "scheduler": state.scheduler.state_dict(),
    }, target + ".tmp")
    os.replace(target + ".tmp", target)
    return path


def latest_checkpoint(ckpt_dir: str) -> str | None:
    """The ``step_<n>`` directory of ``ckpt_dir`` with the largest n that
    holds a state file, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [
        (int(d.split("_")[1]), d)
        for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and d.split("_")[1].isdigit()
        and os.path.isfile(os.path.join(ckpt_dir, d, STATE_FILE))
    ]
    if not steps:
        return None
    return os.path.join(ckpt_dir, max(steps)[1])


def load_state_file(path: str) -> dict:
    """The saved dict of a step directory (or of a ``state.pt`` itself),
    tensors on the CPU."""
    if os.path.isdir(path):
        path = os.path.join(path, STATE_FILE)
    return torch.load(path, map_location="cpu", weights_only=True)


def restore_checkpoint(path: str, state: TrainState) -> TrainState:
    """Loads a step directory into ``state`` in place (the model strictly)
    and returns it."""
    saved = load_state_file(path)
    state.model.load_state_dict(saved["model"], strict=True)
    state.optimizer.load_state_dict(saved["optimizer"])
    state.scheduler.load_state_dict(saved["scheduler"])
    state.step = int(saved["step"])
    return state
