"""Reference checkpoints: the reference's torch state_dict <-> the port's.

Counterpart of ``creste_public_tpu/training/torch_import.py``, with its own
copy of the rules. The port is OIHW / NCHW like the reference, so every
tensor carries over as it is (a depthwise conv is (C, 1, k, k) on both
sides, a dense weight (out, in), the PE-free map [1, C, h, w]); what
changes is the name. The reference's efficientnet_pytorch trunk
(``_blocks.N._*``), its ``Up`` decoders (``upN.conv.K``), torchvision's
ResNet layers (``layerL.B.convK``, ``downsample.K``), the ``out_heads``,
the Sequential ``model.K`` / ``convs.K`` of its MultiLayerConv heads and
the reward net's named ConvLayers become the port's flax-scope names
(``trunk.block_N.*``, ``upN.conv_K``, ``layerL_B.*``, ``head_i.*``,
``Conv_K`` / ``BatchNorm_K``, ``prepool_i.Conv_0``, ...). A leading
``model.`` (the Lightning module) is stripped, ``num_batches_tracked`` and
the classification tail of the trunk are dropped, and every other key that
no rule takes is reported. ``export_reference_style`` is the inverse, so a
round trip checks the table without the released weights.
"""
from __future__ import annotations

import re
from collections.abc import Callable, Mapping

import numpy as np
import torch

_BN = r"(?P<leaf>weight|bias|running_mean|running_var)"
_WB = r"(?P<leaf>weight|bias)"
_PRE = r"(?P<pre>(?:[\w.]+\.)?)"
_EFF = _PRE + r"vision_backbone\.model\."
_PEFF = _PRE + r"vision_backbone\.effnet\."
_BEV = _PRE + r"bevclassifier\."

Rule = tuple[re.Pattern, Callable[[re.Match, Mapping], str | None]]


def _fmt(template: str) -> Callable[[re.Match, Mapping], str]:
    return lambda m, sd: template.format(**m.groupdict())


def _seq_period(sd: Mapping, seq_prefix: str) -> int:
    """3 for a conv / BN / ReLU Sequential (a ``running_mean`` at index 1,
    4, 7 or 10 under ``seq_prefix``), else 2 (conv / ReLU)."""
    with_bn = any(k.startswith(seq_prefix) and k.endswith("running_mean")
                  and k[len(seq_prefix):].split(".")[0] in ("1", "4", "7",
                                                             "10")
                  for k in sd)
    return 3 if with_bn else 2


def _mlc(head: str, seq: str):
    """A reference MultiLayerConv Sequential ``<head>.<seq>.K`` -> the
    port's ``<head>.Conv_i`` / ``<head>.BatchNorm_i``."""
    def fn(m: re.Match, sd: Mapping) -> str | None:
        pre, k = m["pre"], int(m["k"])
        period = _seq_period(sd, f"{pre}{head}.{seq}.")
        layer, off = divmod(k, period)
        if off == 0:
            return f"{pre}{head}.Conv_{layer}.{m['leaf']}"
        if off == 1 and period == 3:
            return f"{pre}{head}.BatchNorm_{layer}.{m['leaf']}"
        raise KeyError(f"{m.string}: Sequential index {k} is an activation")
    return fn


def _up(base: str):
    """``...conv.K`` of an ``Up`` block: 0 and 3 the convs, 1 and 4 the
    BNs (2 and 5 are ReLUs)."""
    def fn(m: re.Match, sd: Mapping) -> str | None:
        name = {0: "conv_0", 3: "conv_1", 1: "bn_0", 4: "bn_1"}[int(m["k"])]
        return base.format(**m.groupdict()) + f"{name}.{m['leaf']}"
    return fn


def _import_rules() -> list[Rule]:
    rules: list[Rule] = []

    def add(pattern: str, fn):
        rules.append((re.compile(pattern + "$"), fn))

    trunk = "{pre}vision_backbone.effnet.trunk."
    add(_EFF + r"trunk\._conv_stem\.weight", _fmt(trunk + "conv_stem.weight"))
    add(_EFF + r"trunk\._bn0\." + _BN, _fmt(trunk + "bn0.{leaf}"))
    add(_EFF + r"trunk\._blocks\.(?P<i>\d+)\._(?P<c>expand_conv|project_conv"
        r"|depthwise_conv)\.weight", _fmt(trunk + "block_{i}.{c}.weight"))
    add(_EFF + r"trunk\._blocks\.(?P<i>\d+)\._(?P<c>se_reduce|se_expand)\."
        + _WB, _fmt(trunk + "block_{i}.{c}.{leaf}"))
    add(_EFF + r"trunk\._blocks\.(?P<i>\d+)\._bn(?P<j>[012])\." + _BN,
        _fmt(trunk + "block_{i}.bn{j}.{leaf}"))
    add(_EFF + r"trunk\._(?:conv_head|bn1|fc)\.\w+", lambda m, sd: None)
    add(_EFF + r"up(?P<u>\d+)\.conv\.(?P<k>[0134])\.(?P<leaf>\w+)",
        _up("{pre}vision_backbone.effnet.up{u}."))
    add(_EFF + r"conv\." + _WB, _fmt("{pre}vision_backbone.effnet.conv.{leaf}"))
    add(_EFF + r"bn\." + _BN, _fmt("{pre}vision_backbone.effnet.bn.{leaf}"))

    for head in ("depth_head", "dino_head"):
        add(_PRE + head + r"\.model\.(?P<k>\d+)\.(?P<leaf>\w+)",
            _mlc(head, "model"))
    add(_PRE + r"cam2map\.z_proj\.(?P<k>\d+)\." + _WB,
        lambda m, sd: f"{m['pre']}cam2map.z_proj.Dense_{int(m['k']) // 2}"
                      f".{m['leaf']}")
    # the reference's ConvEncoder keeps its Sequential as `.convs`
    for seq in ("convs", "model"):
        add(_PRE + r"cam2map\.vision_fusion\." + seq
            + r"\.(?P<k>\d+)\.(?P<leaf>\w+)",
            _mlc("cam2map.vision_fusion", seq))

    add(_BEV + r"conv1\.weight", _fmt("{pre}bevclassifier.conv1.weight"))
    add(_BEV + r"bn1\." + _BN, _fmt("{pre}bevclassifier.bn1.{leaf}"))
    block = "{pre}bevclassifier.layer{L}_{B}."
    add(_BEV + r"layer(?P<L>\d)\.(?P<B>\d)\.(?P<part>conv[12])\.weight",
        _fmt(block + "{part}.weight"))
    add(_BEV + r"layer(?P<L>\d)\.(?P<B>\d)\.(?P<part>bn[12])\." + _BN,
        _fmt(block + "{part}.{leaf}"))
    add(_BEV + r"layer(?P<L>\d)\.(?P<B>\d)\.downsample\.0\.weight",
        _fmt(block + "down_conv.weight"))
    add(_BEV + r"layer(?P<L>\d)\.(?P<B>\d)\.downsample\.1\." + _BN,
        _fmt(block + "down_bn.{leaf}"))
    head = "{pre}bevclassifier.head_{i}."
    add(_BEV + r"out_heads\.(?P<i>\d+)\.up1\.conv\.(?P<k>[0134])\."
        r"(?P<leaf>\w+)", _up(head + "up1."))
    add(_BEV + r"out_heads\.(?P<i>\d+)\.up2\.1\.weight",
        _fmt(head + "up2_conv.weight"))
    add(_BEV + r"out_heads\.(?P<i>\d+)\.up2\.2\." + _BN,
        _fmt(head + "up2_bn.{leaf}"))
    add(_BEV + r"out_heads\.(?P<i>\d+)\.proj\." + _WB,
        _fmt(head + "proj.{leaf}"))

    # the reward net: named ConvLayers (conv / norm / relu); the trunk
    # interleaves bn-free ConvLayers (index 1 + 3i) with bare BNs (2 + 3i)
    add(_PRE + r"r\.(?P<part>prepool|skip|postpool)\.(?P<i>\d+)\.conv\."
        + _WB, _fmt("{pre}r.{part}_{i}.Conv_0.{leaf}"))
    add(_PRE + r"r\.(?P<part>prepool|skip|postpool)\.(?P<i>\d+)\.norm\."
        + _BN, _fmt("{pre}r.{part}_{i}.BatchNorm_0.{leaf}"))
    add(_PRE + r"r\.trunk\.(?P<k>\d+)\.conv\." + _WB,
        lambda m, sd: f"{m['pre']}r.trunk_{(int(m['k']) - 1) // 3}.Conv_0"
                      f".{m['leaf']}")
    add(_PRE + r"r\.trunk\.(?P<k>\d+)\." + _BN,
        lambda m, sd: f"{m['pre']}r.trunk_bn_{(int(m['k']) - 2) // 3}"
                      f".{m['leaf']}")

    tl = "{pre}temporal_layer."
    add(_PRE + r"temporal_layer\.pre_rnn_conv\.conv\.weight",
        _fmt(tl + "pre_rnn_conv.weight"))
    add(_PRE + r"temporal_layer\.pre_rnn_conv\.norm\." + _BN,
        _fmt(tl + "pre_rnn_bn.{leaf}"))
    add(_PRE + r"temporal_layer\.rnn\.cell_list\.(?P<i>\d+)\.(?P<c>conv_gates"
        r"|conv_can)\." + _WB, _fmt(tl + "rnn.cell_{i}.{c}.{leaf}"))
    add(_PRE + r"temporal_layer\.rnn\.z_map\.(?P<k>0|2)\." + _WB,
        _fmt(tl + "rnn.z_map_{k}.{leaf}"))

    add(_PRE + r"learnable_pe_map", _fmt("{pre}learnable_pe_map"))
    add(_PRE + r"pe_head\.0\." + _WB, _fmt("{pre}pe_head_conv.{leaf}"))
    add(_PRE + r"pe_head\.1\." + _BN, _fmt("{pre}pe_head_bn.{leaf}"))
    add(_PRE + r"log_var(?:iance)?", _fmt("{pre}log_var"))
    return rules


def _export_rules() -> list[Rule]:
    """The inverse table: port key -> reference key (without ``model.``)."""
    rules: list[Rule] = []

    def add(pattern: str, fn):
        rules.append((re.compile(pattern + "$"), fn))

    def seq(head: str, ref_seq: str):
        def fn(m: re.Match, sd: Mapping) -> str:
            pre, k = m["pre"], int(m["k"])
            period = 3 if f"{pre}{head}.BatchNorm_0.running_mean" in sd else 2
            idx = period * k + (m["kind"] == "BatchNorm")
            return f"{pre}{head}.{ref_seq}.{idx}.{m['leaf']}"
        return fn

    def up(ref_base: str):
        def fn(m: re.Match, sd: Mapping) -> str:
            k = int(m["k"])
            idx = 3 * k + (m["kind"] == "bn")
            return ref_base.format(**m.groupdict()) + f"{idx}.{m['leaf']}"
        return fn

    trunk = "{pre}vision_backbone.model.trunk."
    add(_PEFF + r"trunk\.conv_stem\.weight", _fmt(trunk + "_conv_stem.weight"))
    add(_PEFF + r"trunk\.bn0\." + _BN, _fmt(trunk + "_bn0.{leaf}"))
    add(_PEFF + r"trunk\.block_(?P<i>\d+)\.(?P<c>expand_conv|project_conv|"
        r"depthwise_conv|se_reduce|se_expand)\." + _WB,
        _fmt(trunk + "_blocks.{i}._{c}.{leaf}"))
    add(_PEFF + r"trunk\.block_(?P<i>\d+)\.bn(?P<j>[012])\." + _BN,
        _fmt(trunk + "_blocks.{i}._bn{j}.{leaf}"))
    add(_PEFF + r"up(?P<u>\d+)\.(?P<kind>conv|bn)_(?P<k>[01])\.(?P<leaf>\w+)",
        up("{pre}vision_backbone.model.up{u}.conv."))
    add(_PEFF + r"conv\." + _WB, _fmt("{pre}vision_backbone.model.conv.{leaf}"))
    add(_PEFF + r"bn\." + _BN, _fmt("{pre}vision_backbone.model.bn.{leaf}"))

    for head in ("depth_head", "dino_head"):
        add(_PRE + head + r"\.(?P<kind>Conv|BatchNorm)_(?P<k>\d+)\."
            r"(?P<leaf>\w+)", seq(head, "model"))
    add(_PRE + r"cam2map\.z_proj\.Dense_(?P<k>\d+)\." + _WB,
        lambda m, sd: f"{m['pre']}cam2map.z_proj.{2 * int(m['k'])}"
                      f".{m['leaf']}")
    add(_PRE + r"cam2map\.vision_fusion\.(?P<kind>Conv|BatchNorm)_(?P<k>\d+)"
        r"\.(?P<leaf>\w+)", seq("cam2map.vision_fusion", "convs"))

    add(_BEV + r"conv1\.weight", _fmt("{pre}bevclassifier.conv1.weight"))
    add(_BEV + r"bn1\." + _BN, _fmt("{pre}bevclassifier.bn1.{leaf}"))
    block = "{pre}bevclassifier.layer{L}.{B}."
    add(_BEV + r"layer(?P<L>\d)_(?P<B>\d)\.(?P<part>conv[12])\.weight",
        _fmt(block + "{part}.weight"))
    add(_BEV + r"layer(?P<L>\d)_(?P<B>\d)\.(?P<part>bn[12])\." + _BN,
        _fmt(block + "{part}.{leaf}"))
    add(_BEV + r"layer(?P<L>\d)_(?P<B>\d)\.down_conv\.weight",
        _fmt(block + "downsample.0.weight"))
    add(_BEV + r"layer(?P<L>\d)_(?P<B>\d)\.down_bn\." + _BN,
        _fmt(block + "downsample.1.{leaf}"))
    head = "{pre}bevclassifier.out_heads.{i}."
    add(_BEV + r"head_(?P<i>\d+)\.up1\.(?P<kind>conv|bn)_(?P<k>[01])\."
        r"(?P<leaf>\w+)", up(head + "up1.conv."))
    add(_BEV + r"head_(?P<i>\d+)\.up2_conv\.weight",
        _fmt(head + "up2.1.weight"))
    add(_BEV + r"head_(?P<i>\d+)\.up2_bn\." + _BN,
        _fmt(head + "up2.2.{leaf}"))
    add(_BEV + r"head_(?P<i>\d+)\.proj\." + _WB, _fmt(head + "proj.{leaf}"))

    add(_PRE + r"r\.(?P<part>prepool|skip|postpool)_(?P<i>\d+)\.Conv_0\."
        + _WB, _fmt("{pre}r.{part}.{i}.conv.{leaf}"))
    add(_PRE + r"r\.(?P<part>prepool|skip|postpool)_(?P<i>\d+)\."
        r"BatchNorm_0\." + _BN, _fmt("{pre}r.{part}.{i}.norm.{leaf}"))
    add(_PRE + r"r\.trunk_(?P<k>\d+)\.Conv_0\." + _WB,
        lambda m, sd: f"{m['pre']}r.trunk.{1 + 3 * int(m['k'])}.conv"
                      f".{m['leaf']}")
    add(_PRE + r"r\.trunk_bn_(?P<k>\d+)\." + _BN,
        lambda m, sd: f"{m['pre']}r.trunk.{2 + 3 * int(m['k'])}.{m['leaf']}")

    tl = "{pre}temporal_layer."
    add(_PRE + r"temporal_layer\.pre_rnn_conv\.weight",
        _fmt(tl + "pre_rnn_conv.conv.weight"))
    add(_PRE + r"temporal_layer\.pre_rnn_bn\." + _BN,
        _fmt(tl + "pre_rnn_conv.norm.{leaf}"))
    add(_PRE + r"temporal_layer\.rnn\.cell_(?P<i>\d+)\.(?P<c>conv_gates|"
        r"conv_can)\." + _WB, _fmt(tl + "rnn.cell_list.{i}.{c}.{leaf}"))
    add(_PRE + r"temporal_layer\.rnn\.z_map_(?P<k>\d+)\." + _WB,
        _fmt(tl + "rnn.z_map.{k}.{leaf}"))

    add(_PRE + r"learnable_pe_map", _fmt("{pre}learnable_pe_map"))
    add(_PRE + r"pe_head_conv\." + _WB, _fmt("{pre}pe_head.0.{leaf}"))
    add(_PRE + r"pe_head_bn\." + _BN, _fmt("{pre}pe_head.1.{leaf}"))
    add(_PRE + r"log_var", _fmt("{pre}log_var"))
    return rules


_IMPORT = _import_rules()
_EXPORT = _export_rules()


def _as_tensor(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach()
    return torch.from_numpy(np.array(v, copy=True))


def import_reference_state_dict(
    sd: Mapping[str, object], strip_prefixes: tuple[str, ...] = ("model.",)
) -> tuple[dict[str, torch.Tensor], list[str]]:
    """A reference state_dict (tensors or arrays) -> (the port's state_dict
    of the keys the rules take, the unmatched keys). ``strip_prefixes`` go
    first; ``num_batches_tracked`` and the trunk's classification tail are
    dropped silently."""
    def strip(key: str) -> str:
        for p in strip_prefixes:
            if key.startswith(p):
                key = key[len(p):]
        return key

    stripped = {strip(k): v for k, v in sd.items()}
    out: dict[str, torch.Tensor] = {}
    unmatched: list[str] = []
    for key, (k, value) in zip(sd, stripped.items()):
        if k.endswith("num_batches_tracked"):
            continue
        for pattern, fn in _IMPORT:
            m = pattern.match(k)
            if m:
                name = fn(m, stripped)
                if name is not None:
                    out[name] = _as_tensor(value)
                break
        else:
            unmatched.append(key)
    return out, unmatched


def merge_into_state(target: Mapping[str, torch.Tensor],
                     imported: Mapping[str, torch.Tensor],
                     require_match: bool = True) -> dict[str, torch.Tensor]:
    """``target`` (a port state_dict) with ``imported``'s tensors laid over
    it, each cast to the target's dtype. A shape mismatch raises
    ValueError; a key the target lacks raises KeyError with
    ``require_match``, else it is left out."""
    out = dict(target)
    for k, v in imported.items():
        if k not in target:
            if require_match:
                raise KeyError(f"the port has no tensor {k}")
            continue
        if tuple(target[k].shape) != tuple(v.shape):
            raise ValueError(f"Shape mismatch at {k}: port "
                             f"{tuple(target[k].shape)} vs reference "
                             f"{tuple(v.shape)}")
        out[k] = v.to(target[k].dtype)
    return out


def load_reference_checkpoint(path: str) -> dict[str, torch.Tensor]:
    """The state_dict of a reference checkpoint file: a Lightning
    checkpoint (its ``state_dict``) or a bare state_dict."""
    raw = torch.load(path, map_location="cpu", weights_only=False)
    return dict(raw.get("state_dict", raw)) if isinstance(raw, dict) else raw


def export_reference_style(state: Mapping[str, torch.Tensor]
                           ) -> dict[str, torch.Tensor]:
    """A port state_dict -> a reference-style one (keys ``model.<reference
    path>``); a key with no reference counterpart (the merged decoder
    heads, the rollout's ``fc``) is left out. Sequential heads take the
    conv / BN / ReLU layout where the port's head has BatchNorms, else
    conv / ReLU."""
    out: dict[str, torch.Tensor] = {}
    for k, v in state.items():
        for pattern, fn in _EXPORT:
            m = pattern.match(k)
            if m:
                out["model." + fn(m, state)] = v
                break
    return out
