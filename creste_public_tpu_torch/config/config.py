"""Nested-dict config with attribute access (plain Python, no YAML).

A copy of the ``Config`` class of the JAX package's config module, without
its YAML composition: the port builds its configurations from the presets
in ``config.presets``.
"""
from __future__ import annotations

import copy
from typing import Any, Mapping


class Config(dict):
    """Nested dict with attribute access. Immutable enough for config use."""

    def __init__(self, data: Mapping[str, Any] | None = None):
        super().__init__()
        for k, v in (data or {}).items():
            self[k] = _wrap(v)

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = _wrap(value)

    def to_dict(self) -> dict:
        return _unwrap(self)

    def copy(self) -> "Config":
        return Config(copy.deepcopy(self.to_dict()))


def _wrap(v: Any) -> Any:
    if isinstance(v, Config):
        return v
    if isinstance(v, Mapping):
        return Config(v)
    if isinstance(v, list):
        return [_wrap(x) for x in v]
    return v


def _unwrap(v: Any) -> Any:
    if isinstance(v, Mapping):
        return {k: _unwrap(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_unwrap(x) for x in v]
    return v
