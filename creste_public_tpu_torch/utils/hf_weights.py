"""Where the foundation models' weights come from: disk only.

The HF loaders of the preprocessing chain read a local checkpoint
directory or the local HF cache, never the hub. ``weights_on_disk`` is the
check they make before importing transformers, so that a machine without
the weights returns None at once instead of paying that import first.
"""
from __future__ import annotations

import os

# from_pretrained's arguments: weights from disk, never from the hub
LOCAL = {"local_files_only": True}


def weights_on_disk(model_id: str) -> bool:
    """True when ``model_id`` is a checkpoint directory holding a
    ``config.json``, or a hub id whose ``config.json`` sits in the local
    HF cache."""
    if os.path.isdir(model_id):
        return os.path.isfile(os.path.join(model_id, "config.json"))
    try:
        from huggingface_hub import try_to_load_from_cache

        return isinstance(try_to_load_from_cache(model_id, "config.json"),
                          str)
    except Exception:
        # no huggingface_hub (then no transformers either), or an id the
        # hub would not accept
        return False
