"""Nested-dict config with attribute access (plain Python, no YAML).

Copies of ``Config``, ``deep_merge`` and ``apply_overrides`` of the JAX
package's config module. The JAX package parses an override's value with
``yaml.safe_load``; the port has no YAML, so ``parse_value`` reads the
YAML 1.1 scalars an override uses (see there). The configurations
themselves are plain dicts: ``config.presets`` and the CLI groups of
``config.groups``.
"""
from __future__ import annotations

import copy
import math
import re
from typing import Any, Iterable, Mapping


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


def deep_merge(base: Mapping, over: Mapping) -> Config:
    """Recursive dict merge; ``over`` wins, lists replace wholesale."""
    out = Config(base)
    for k, v in over.items():
        if k in out and isinstance(out[k], Mapping) and isinstance(v, Mapping):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = _wrap(copy.deepcopy(_unwrap(v)) if isinstance(v, (Mapping, list)) else v)
    return out


# PyYAML's implicit resolvers (YAML 1.1) for the scalars parse_value reads
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False"
                   r"|FALSE|on|On|ON|off|Off|OFF)$")
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                  r"|[-+]?0x[0-9a-fA-F_]+)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?|[-+]?\.(?:inf|Inf|INF)"
                    r"|\.(?:nan|NaN|NAN))$")
_SEXAGESIMAL = re.compile(r"^[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?$")
_DATE = re.compile(r"^[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}")


def _scalar(s: str) -> Any:
    if _NULL.match(s):
        return None
    if _BOOL.match(s):
        return s.lower() in ("yes", "true", "on")
    if _INT.match(s):
        t = s.replace("_", "")
        sign = -1 if t[0] == "-" else 1
        t = t.lstrip("+-")
        if t.startswith("0b"):
            return sign * int(t[2:], 2)
        if t.startswith("0x"):
            return sign * int(t[2:], 16)
        if len(t) > 1 and t[0] == "0":
            return sign * int(t, 8)
        return sign * int(t)
    if _FLOAT.match(s):
        t = s.replace("_", "").lower()
        if t.endswith("inf"):
            return -math.inf if t[0] == "-" else math.inf
        if t.endswith("nan"):
            return math.nan
        return float(t)
    if _SEXAGESIMAL.match(s) or _DATE.match(s):
        raise ValueError(f"override value {s!r}: YAML reads it as a time or "
                         "a date, which parse_value does not; quote it")
    return s


def _split_flow(body: str) -> list[str]:
    """The items of a flow sequence's body, split at top-level commas."""
    items, depth, quote, cur = [], 0, None, ""
    for ch in body:
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch == "[":
            depth += 1
        elif ch == "]":
            depth -= 1
        elif ch == "," and depth == 0:
            items.append(cur)
            cur = ""
            continue
        cur += ch
    if cur.strip():
        items.append(cur)
    return items


def parse_value(raw: str) -> Any:
    """An override value as ``yaml.safe_load`` reads it, for the forms an
    override uses: null (``null``, ``~``, empty), booleans (``true``,
    ``false``, ``yes``, ``no``, ``on``, ``off`` in YAML 1.1's spellings),
    ints (decimal, ``0x``, ``0b``, leading-zero octal, ``_`` separators),
    floats (YAML 1.1 needs a dot: ``5.0e-4`` is a float, ``5e-4`` stays the
    string it is for PyYAML), ``.inf``/``.nan``, single- and double-quoted
    strings, flow sequences ``[a, b]`` (nested too), and plain strings.
    Raises on a flow mapping, a time or a date, which it does not read."""
    s = raw.strip()
    if s.startswith("[") and s.endswith("]"):
        return [parse_value(x) for x in _split_flow(s[1:-1])]
    if s.startswith("{"):
        raise ValueError(f"override value {raw!r}: flow mappings are not "
                         "supported")
    if len(s) >= 2 and s[0] == s[-1] == "'":
        return s[1:-1].replace("''", "'")
    if len(s) >= 2 and s[0] == s[-1] == '"':
        return (s[1:-1].encode("latin-1", "backslashreplace")
                .decode("unicode_escape"))
    return _scalar(s)


def apply_overrides(cfg: Config, overrides: Iterable[str]) -> Config:
    """Apply hydra-style dotted overrides: ``a.b.c=value``."""
    cfg = Config(cfg)
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"Override must look like key=value, got {ov!r}")
        key, _, raw = ov.partition("=")
        parts = key.lstrip("+").split(".")
        node = cfg
        for i, p in enumerate(parts[:-1]):
            if p not in node:
                node[p] = Config()
            elif not isinstance(node[p], Mapping):
                # never silently clobber an existing non-mapping value
                raise ValueError(
                    f"Override {ov!r}: {'.'.join(parts[: i + 1])!r} is a "
                    f"{type(node[p]).__name__}, not a config section — "
                    "list/scalar paths cannot be overridden with dotted keys"
                )
            node = node[p]
        node[parts[-1]] = _wrap(parse_value(raw))
    return cfg
