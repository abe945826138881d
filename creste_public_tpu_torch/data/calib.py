"""CODa calibration and pose loading (host-side numpy).

Counterpart of ``creste_public_tpu/data/calib.py`` (reference
creste/datasets/coda_helpers.py:21-140): ROS-style calibration files
(camera_matrix / rectification_matrix / projection_matrix and the
os1->camera extrinsic/projection pair), quaternion pose rows ``ts x y z qw
qx qy qz``, and intrinsic scaling for feature-resolution projection
matrices.

The JAX package reads the two calibration files with ``yaml.safe_load``.
The port has no YAML library, so ``read_calibration_yaml`` parses the
subset these files are written in: block mappings, block sequences (the
``- 1.0`` items ``yaml.safe_dump`` writes, indented or not), flow
sequences and flow mappings (``{rows: 3, cols: 4, data: [...]}``), either
spread over several lines, ``#`` comments, and scalars as
``config.parse_value`` reads them (YAML 1.1's null, bool, int and float
forms, quoted and plain strings). Anything else (anchors, aliases, tags,
block scalars, complex keys, directives, a second document) raises
``ValueError`` naming its line rather than being guessed at.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any

import numpy as np

from creste_public_tpu_torch.config.config import parse_value
from creste_public_tpu_torch.data.coda_constants import (
    CALIBRATION_DIR,
    POSES_DIR,
)
from creste_public_tpu_torch.utils.geometry import quat_to_rotmat

_UNSUPPORTED = {"&": "an anchor", "*": "an alias", "!": "a tag",
                "|": "a block scalar", ">": "a block scalar",
                "?": "a complex key", "@": "a reserved indicator",
                "`": "a reserved indicator"}


def _opens_quote(text: str, i: int) -> bool:
    """A quote at ``text[i]`` starts a quoted scalar only at the start of
    a token (``it's`` is a plain scalar)."""
    return text[i] in "'\"" and (i == 0 or text[i - 1] in " [{,:")


def _strip_comment(line: str) -> str:
    """``line`` without its comment (a '#' inside quotes is text)."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif _opens_quote(line, i):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1].isspace()):
            return line[:i].rstrip()
    return line.rstrip()


class _Lines:
    """The file's content lines: (line number, indent, text)."""

    def __init__(self, text: str, name: str):
        self.name = name
        self.items: list[tuple[int, int, str]] = []
        started = False
        for no, raw in enumerate(text.splitlines(), 1):
            if "\t" in raw[:len(raw) - len(raw.lstrip())]:
                self.fail(no, "a tab in the indentation")
            line = _strip_comment(raw)
            if not line.strip():
                continue
            body = line.strip()
            if line.startswith("%"):
                self.fail(no, "a directive")
            if body == "---" and not started and not line[0].isspace():
                started = True
                continue
            if body in ("---", "...") or body.startswith("--- "):
                self.fail(no, "a document marker (one document only)")
            started = True
            self.items.append((no, len(line) - len(line.lstrip()), body))

    def fail(self, no: int, what: str):
        raise ValueError(f"{self.name}:{no}: {what} is not supported by "
                         "the calibration reader")


def _split_key(body: str) -> tuple[str, str] | None:
    """``key: rest`` -> (key, rest) at the first ':' followed by a space
    or the end, outside quotes and brackets; None for a line with none."""
    quote, depth = None, 0
    for i, ch in enumerate(body):
        if quote:
            if ch == quote:
                quote = None
        elif _opens_quote(body, i):
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
        elif ch == ":" and depth == 0 and (i + 1 == len(body)
                                           or body[i + 1] == " "):
            return body[:i].strip(), body[i + 1:].strip()
    return None


class _Flow:
    """A flow collection or scalar, parsed from one string."""

    def __init__(self, text: str, fail):
        self.s, self.i, self.fail = text, 0, fail

    def ws(self):
        while self.i < len(self.s) and self.s[self.i].isspace():
            self.i += 1

    def node(self, stops: str) -> Any:
        self.ws()
        if self.i >= len(self.s):
            return None
        ch = self.s[self.i]
        if ch == "[":
            return self.collection("]", lambda: self.node(",]"))
        if ch == "{":
            out: dict = {}

            def entry():
                key = self.node(",}:")
                self.ws()
                if self.i < len(self.s) and self.s[self.i] == ":":
                    self.i += 1
                    out[key] = self.node(",}")
                else:
                    out[key] = None
            self.collection("}", entry)
            return out
        if ch in _UNSUPPORTED:
            self.fail(_UNSUPPORTED[ch])
        return self.scalar(stops)

    def collection(self, close: str, item) -> Any:
        self.i += 1
        items = []
        while True:
            self.ws()
            if self.i >= len(self.s):
                self.fail(f"an unclosed flow collection (no {close!r})")
            if self.s[self.i] == close:
                self.i += 1
                return items
            items.append(item())
            self.ws()
            if self.i < len(self.s) and self.s[self.i] == ",":
                self.i += 1
            elif self.i >= len(self.s) or self.s[self.i] != close:
                self.fail(f"a flow collection without ',' or {close!r}")

    def scalar(self, stops: str) -> Any:
        start = self.i
        if self.s[self.i] in "'\"":
            q = self.s[self.i]
            self.i += 1
            while self.i < len(self.s):
                if self.s[self.i] == q:
                    if q == "'" and self.s[self.i + 1:self.i + 2] == "'":
                        self.i += 2
                        continue
                    if q == '"' and self.s[self.i - 1] == "\\":
                        self.i += 1
                        continue
                    break
                self.i += 1
            else:
                self.fail("an unclosed quoted string")
            self.i += 1
            return parse_value(self.s[start:self.i])
        while self.i < len(self.s):
            ch = self.s[self.i]
            if ch in stops and (ch != ":" or self.i + 1 == len(self.s)
                                or self.s[self.i + 1] in " ,]}"):
                break
            self.i += 1
        return parse_value(self.s[start:self.i].strip())


def _value(text: str, fail) -> Any:
    """A value written on one (joined) line: flow collection or scalar."""
    if text and text[0] in _UNSUPPORTED:
        fail(_UNSUPPORTED[text[0]])
    flow = _Flow(text, fail)
    out = flow.node("")
    flow.ws()
    if flow.i != len(text):
        fail(f"trailing text {text[flow.i:]!r}")
    return out


def _balance(text: str) -> int:
    depth, quote = 0, None
    for i, ch in enumerate(text):
        if quote:
            quote = None if ch == quote else quote
        elif _opens_quote(text, i):
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
    return depth


class _Block:
    def __init__(self, lines: _Lines):
        self.lines = lines
        self.items = lines.items
        self.pos = 0

    def fail(self, what: str, at: int | None = None):
        at = self.pos if at is None else at
        no = self.items[min(at, len(self.items) - 1)][0] if self.items else 1
        self.lines.fail(no, what)

    def inline(self, text: str) -> Any:
        """A value starting on the current line (already consumed): joins
        the continuation lines of an unclosed flow collection."""
        at = self.pos - 1
        while _balance(text) > 0:
            if self.pos >= len(self.items):
                self.fail("an unclosed flow collection", at)
            text += " " + self.items[self.pos][2]
            self.pos += 1
        return _value(text, lambda w: self.fail(w, at))

    def node(self, indent: int) -> Any:
        no, ind, body = self.items[self.pos]
        if ind < indent:
            self.fail("a missing value")
        if body == "-" or body.startswith("- "):
            return self.sequence(ind)
        if _split_key(body) is not None:
            return self.mapping(ind)
        self.pos += 1
        out = self.inline(body)
        if self.pos < len(self.items) and self.items[self.pos][1] > ind:
            self.fail("a multi-line plain scalar", self.pos)
        return out

    def sequence(self, ind: int) -> list:
        out = []
        while self.pos < len(self.items):
            no, i, body = self.items[self.pos]
            if i != ind or not (body == "-" or body.startswith("- ")):
                break
            rest = body[1:].strip()
            if not rest:
                self.pos += 1
                out.append(self.nested(ind, in_sequence=True))
            elif (rest == "-" or rest.startswith("- ")
                  or (_split_key(rest) is not None
                      and rest[0] not in "[{'\"")):
                # '- key: value' or '- - item': a mapping or a sequence
                # whose column is the item's
                col = ind + len(body) - len(rest)
                self.items[self.pos] = (no, col, rest)
                out.append(self.node(col))
            else:
                self.pos += 1
                out.append(self.inline(rest))
        return out

    def mapping(self, ind: int) -> dict:
        out: dict = {}
        while self.pos < len(self.items):
            no, i, body = self.items[self.pos]
            if i < ind:
                break
            if i > ind:
                self.fail("an unexpected indentation")
            kv = _split_key(body)
            if kv is None:
                if body == "-" or body.startswith("- "):
                    break
                self.fail("a line that is no 'key: value'")
            key_text, rest = kv
            key = _value(key_text, lambda w: self.fail(w))
            if key in out:
                self.fail(f"a second key {key!r}")
            self.pos += 1
            out[key] = (self.inline(rest) if rest
                        else self.nested(ind, in_sequence=False))
        return out

    def nested(self, ind: int, in_sequence: bool) -> Any:
        """The block node under a ``key:`` or ``-`` with nothing after
        it: more indented, or a sequence at the key's own indentation (the
        indentless sequence ``yaml.safe_dump`` writes); else null."""
        if self.pos >= len(self.items):
            return None
        _, i, body = self.items[self.pos]
        if i > ind:
            return self.node(i)
        if (not in_sequence and i == ind
                and (body == "-" or body.startswith("- "))):
            return self.sequence(ind)
        return None


def parse_calibration_yaml(text: str, name: str = "<string>") -> Any:
    """``text`` as ``yaml.safe_load`` reads it, for the subset of the
    module docstring; raises ``ValueError`` naming the line of anything
    else."""
    lines = _Lines(text, name)
    if not lines.items:
        return None
    block = _Block(lines)
    out = block.node(0)
    if block.pos != len(block.items):
        block.fail("text after the document's root node")
    return out


def read_calibration_yaml(path: str) -> Any:
    """The calibration file at ``path``, as ``yaml.safe_load`` reads it."""
    with open(path) as f:
        return parse_calibration_yaml(f.read(), path)


def _mat(node: dict) -> np.ndarray:
    rows = int(node.get("rows", 3))
    cols = int(node.get("cols", 3))
    return np.asarray(node["data"], np.float64).reshape(rows, cols)


@dataclass
class Calibration:
    K: np.ndarray  # [3,3] camera matrix
    R: np.ndarray  # [3,3] rectification
    P: np.ndarray  # [3,4] rectified projection
    lidar2cam: np.ndarray  # [4,4]
    lidar2camrect: np.ndarray  # [3,4] or [4,4]
    img_hw: tuple[int, int] = field(default=(0, 0))

    def scaled(self, scale: float) -> "Calibration":
        """Intrinsics at a downsampled image resolution (coda_helpers.py:60).

        lidar2camrect is recomputed exactly as the reference's
        get_pts2pixel_transform (projection.py:37-60): M(P[:3,:3]) @ R @
        lidar2cam — the rectification matrix IS applied and P's fourth
        (baseline) column is NOT.
        """
        K = self.K.copy()
        P = self.P.copy()
        K[:2] *= scale
        P[:2] *= scale
        M = np.eye(4)
        M[:3, :3] = P[:3, :3]
        canon = np.eye(4)
        canon[:3, :3] = self.R
        l2c = np.eye(4)
        l2c[:3, :] = self.lidar2cam[:3, :]
        l2r = M @ canon @ l2c
        return Calibration(
            K=K, R=self.R, P=P,
            lidar2cam=self.lidar2cam,
            lidar2camrect=l2r,
            img_hw=(int(self.img_hw[0] * scale), int(self.img_hw[1] * scale)),
        )

    def pixel_to_point(self, ds: float = 1.0) -> np.ndarray:
        """[4,4] pixel(+depth) -> LiDAR-frame point transform: the inverse
        of the rectified projection, homogenised (the dataset's `p2p`,
        codapefree_dataloader.py:803-841)."""
        c = self.scaled(1.0 / ds) if ds != 1.0 else self
        l2r = np.asarray(c.lidar2camrect, np.float64)
        if l2r.shape == (3, 4):
            h = np.eye(4)
            h[:3] = l2r
            l2r = h
        return np.linalg.inv(l2r).astype(np.float32)


def load_calibration(root: str, seq: int | str,
                     cam: str = "cam0") -> Calibration:
    cal_dir = os.path.join(root, CALIBRATION_DIR, str(seq))
    intr = read_calibration_yaml(
        os.path.join(cal_dir, f"calib_{cam}_intrinsics.yaml"))
    extr = read_calibration_yaml(
        os.path.join(cal_dir, f"calib_os1_to_{cam}.yaml"))
    l2c = _mat(extr["extrinsic_matrix"])
    if l2c.shape[0] == 3:
        l2c = np.vstack([l2c, [0, 0, 0, 1]])
    return Calibration(
        K=_mat(intr["camera_matrix"]),
        R=_mat(intr["rectification_matrix"]),
        P=_mat(intr["projection_matrix"]),
        lidar2cam=l2c,
        lidar2camrect=_mat(extr["projection_matrix"]),
        img_hw=(int(intr["image_height"]), int(intr["image_width"])),
    )


def poses_to_matrices(rows: np.ndarray) -> np.ndarray:
    """[N, 8] ``ts x y z qw qx qy qz`` rows -> [N, 4, 4] SE(3)
    (coda_helpers.py:74)."""
    n = rows.shape[0]
    out = np.tile(np.eye(4, dtype=np.float64), (n, 1, 1))
    out[:, :3, :3] = quat_to_rotmat(rows[:, 4:8])
    out[:, :3, 3] = rows[:, 1:4]
    return out


def load_poses(root: str, seq: int | str, subdir: str = "dense") -> np.ndarray:
    """[N, 4, 4] LiDAR poses for a sequence; row i is frame i."""
    path = os.path.join(root, POSES_DIR, subdir, f"{seq}.txt")
    rows = np.loadtxt(path, dtype=np.float64).reshape(-1, 8)
    return poses_to_matrices(rows)
