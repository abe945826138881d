"""Metric logging: a JSONL record plus stdout.

A copy of the JAX package's ``utils/logging.MetricLogger`` (one JSON object
per ``log`` call, the same keys), without its optional TensorBoard and W&B
sinks. ``log_image`` has the JAX signature; as in the JAX training loop,
which opens its logger without a TensorBoard directory, it writes nothing
(the loop's validation images are kept as PNGs, ``training/visual_log``).
"""
from __future__ import annotations

import json
import os
from typing import Any


class MetricLogger:
    def __init__(self, jsonl_path: str | None = None, stdout: bool = True):
        self.stdout = stdout
        self.jsonl_path = jsonl_path
        if jsonl_path:
            os.makedirs(os.path.dirname(os.path.abspath(jsonl_path)),
                        exist_ok=True)

    def log(self, metrics: dict[str, Any]) -> None:
        if self.jsonl_path:
            with open(self.jsonl_path, "a") as f:
                f.write(json.dumps(metrics, default=float) + "\n")
        if self.stdout:
            step = metrics.get("step", "?")
            keys = [
                f"{k}={v:.4g}" for k, v in metrics.items()
                if isinstance(v, (int, float)) and k not in ("step", "epoch")
            ][:8]
            print(f"[step {step}] " + " ".join(keys), flush=True)

    def log_image(self, tag: str, image, step: int = 0) -> None:
        """An HWC uint8/float image for TensorBoard: no sink here."""
