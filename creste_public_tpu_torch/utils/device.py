"""Device selection for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``torch.device`` for an entry point; raises when CUDA is asked for
    and absent. Entry points default to ``"cuda"``: running on the CPU is
    something a caller (the tests) asks for with ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
