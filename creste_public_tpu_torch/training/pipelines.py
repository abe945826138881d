"""Stage plumbing between a batch, the model and the LossManager.

Counterpart of ``creste_public_tpu/training/pipelines.py:54-73``: the
positional model arguments of a stage and the merged tensor dict that the
losses read (``inputs/<batch key>``, ``outputs/<model key>``, ``task``).
"""
from __future__ import annotations


def model_inputs(stage: str, batch: dict) -> tuple:
    """Positional model args for a stage from the batch dict."""
    rgbd = batch["image"]
    p2p = batch["p2p"]
    if stage in ("depth", "distillation"):
        return (rgbd, p2p)
    if stage == "ssc":
        return (rgbd, p2p, batch.get("mv_mask", None))
    return (rgbd, p2p, batch.get("traversability_label", None))


def merge_tensor_dict(batch: dict, outputs: dict,
                      task: str | None = None) -> dict:
    td: dict = {}
    for k, v in batch.items():
        td[f"inputs/{k}"] = v
    for k, v in outputs.items():
        td[f"outputs/{k}"] = v
    if task is not None:
        td["task"] = task
    return td
