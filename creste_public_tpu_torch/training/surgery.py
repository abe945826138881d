"""Cross-stage checkpoint surgery: load a checkpoint of the same stage,
or a previous stage's into the next stage's model.

Counterpart of ``creste_public_tpu/training/surgery.py``. The stages nest:
a stage-1 DistillationBackbone IS TerrainNet's ``depthcomp`` submodule, and
a stage-2 TerrainNet IS MaxEntIRL's ``backbone``, so a previous stage's
checkpoint grafts in whole under that submodule; a checkpoint of the same
stage (the same top-level modules) is restored whole, except the subtrees
a ``ft_decoders_*`` load setting re-initialises. Stages 0 and 1 have no
submodule to graft into: they restore only their own stage's checkpoints
(the JAX package restores a stage-0 tree into stage 1 whole, without the
``dino_head``, and its step then fails). A checkpoint with tensors that the
submodule lacks (a PE-free stage-1 model's PE map, PE head and multiview
splat, which TerrainNet's ``depthcomp`` does not have) is refused: the JAX
package grafts them and its first training step fails on the optimizer's
tree. Checkpoints are the port's torch files (``training/checkpoint.py``).
Freeze policies belong to the optimizer (``optim.LOAD_SETTING_FROZEN``),
not here.
"""
from __future__ import annotations

import os
from typing import Callable

from creste_public_tpu_torch.training.checkpoint import (
    STATE_FILE,
    latest_checkpoint,
    load_state_file,
)
from creste_public_tpu_torch.training.state import TrainState

# stage being trained -> the submodule a previous stage's whole model
# grafts into
STAGE_SUBMODULE = {"ssc": "depthcomp", "traversability": "backbone"}

# subtrees a load setting does not restore: the decoder heads fine-tune
# from their fresh init (terrainnet.py:184-189, :213-218 of the reference)
LOAD_SETTING_SKIP_RESTORE: dict[str, Callable[[str], bool]] = {
    "ft_decoders_all": lambda p: "bevclassifier" in p and "head_" in p,
    "ft_decoders_partial": lambda p: (
        "bevclassifier" in p and "head_" in p
        and ("up2" in p or "proj" in p)
    ),
}


def load_raw_checkpoint(path: str) -> dict:
    """The model state dict of a step directory, a ``state.pt``, or the
    latest step of a checkpoint directory."""
    if os.path.isdir(path) and not os.path.isfile(
            os.path.join(path, STATE_FILE)):
        latest = latest_checkpoint(path)
        if latest is None:
            raise FileNotFoundError(f"No checkpoints under {path}")
        path = latest
    return load_state_file(path)["model"]


def _top(keys) -> set[str]:
    return {k.split(".", 1)[0] for k in keys}


def make_stage_loader(stage: str, weights_path: str,
                      load_setting: str = "strict"
                      ) -> Callable[[TrainState], TrainState]:
    """Returns load(state) -> state with the checkpoint at ``weights_path``
    loaded into ``state.model`` in place; raises ValueError on a checkpoint
    that is neither of the stage nor graftable into it."""
    sub = STAGE_SUBMODULE.get(stage)

    def load(state: TrainState) -> TrainState:
        raw = load_raw_checkpoint(weights_path)
        target = state.model.state_dict()
        if _top(raw) == _top(target):  # a same-stage checkpoint
            skip = LOAD_SETTING_SKIP_RESTORE.get(load_setting)
            if skip is not None:
                raw = {k: target[k] if skip(k) else v
                       for k, v in raw.items()}
            state.model.load_state_dict(raw, strict=True)
            return state
        if sub is None:
            raise ValueError(
                f"stage {stage!r} restores only a checkpoint of its own "
                f"stage (modules {sorted(_top(target))}); {weights_path} "
                f"holds {sorted(_top(raw))}")
        module = getattr(state.model, sub)
        extra = _top(set(raw) - set(module.state_dict()))
        if extra:
            raise ValueError(
                f"{weights_path} holds {sorted(extra)}, which the {stage} "
                f"model's {sub!r} does not have: it does not graft")
        module.load_state_dict(raw, strict=True)
        return state

    return load
