"""Spatial inference: one frame's width split across the ranks of a
``torch.distributed`` group.

Counterpart of ``creste_public_tpu/parallel/mesh.py``'s spatial axis
(``SPATIAL_AXIS``, ``make_spatial_mesh``, ``spatial_inference_shardings``)
and of what GSPMD does with it: the RGBD width ([B, V, H, W, C], axis 3)
is split over a 1-D mesh of ranks and every layer of the deployment graph
runs on each rank's columns, fetching the columns it reads from the ranks
that own them. Data parallelism cannot lower one frame's latency; this can.

Every tensor of ``L`` columns is split as GSPMD splits a dimension: rank
``r`` owns ``[r * c, (r + 1) * c)`` of ``c = ceil(L / N)``, clipped to
``L``, so the last ranks may own fewer columns or none (``partition``). A
rank that owns none still joins every collective.

The primitives work in global coordinates on a ``Strip`` (an NCHW tensor
holding this rank's columns of a tensor ``width`` wide):

- ``conv2d`` at any kernel, stride, groups and (asymmetric) padding: the
  padding is applied only at the frame's left and right edges, the
  columns a rank's outputs read come from the ranks that own them
  (``fetch``);
- ``max_pool2d``, ``resize_bilinear`` (half-pixel sampling at the global
  sizes, as ``convnets.resize_bilinear``), and ``mean_hw`` (the strip
  sums all-reduced, then divided by the global H * W);
- ``gather_columns``: a sharded tensor back in the one-rank layout.

Eval BatchNorm (folded or not), SiLU and ReLU are per pixel and run on
the strip as the modules do. The walkers below (``effnet``,
``depth_completion``, ``cam2map``, ``decoder``, ``reward``) run the
port's modules with these primitives: the EffNet-b0 trunk and its ``Up``
decoder, the depth and DINO heads, the splat (each rank splats its pixels
into full-grid sums, or in ``max`` mode full-grid maxima from a zero grid,
which are all-reduced), the BEV decoder on each rank's columns of the
grid (its heads one by one or merged), and the reward head, on the card
one launch of ``creste::msfcn_head`` per rank on its columns of the input
view plus a halo (``HEAD_HALO``).
``runtime.export.build_spatial_inference_fn`` puts them together.

The split graph is the eval deployment graph in every serving variant:
f32 or the bf16 stream (``compute_dtype``), folded BatchNorms or not,
merged heads or not, the fused head or the unfused one, a ``mean``,
``sum`` or ``max`` splat. Each primitive computes in the dtype the module
it stands for computes in: a convolution in the promotion of its input's
and its weights' dtypes (``convnets.promoted``: a bf16-rounded weight on
an f32 island computes in f32), a resize and a mean in f32 for a bf16
stream (torch's kernels accumulate bf16 in f32 and round once), and the
trunk casts its stream after the stem and the depth head reads it in f32,
as ``effnet`` and ``DepthCompletion`` do. What the split refuses raises
``NotImplementedError``: the temporal merge, stage 1's branches of the
backbone and training mode.

The exchange is built from ``all_gather`` of each rank's edge slabs (one
call per exchange), which gloo takes on the CPU and on CUDA tensors and
NCCL takes too; nothing is copied through the host by the port.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from creste_public_tpu_torch.models.blocks.convnets import (
    ConvLayer,
    MultiLayerConv,
    promoted,
)
from creste_public_tpu_torch.models.blocks.effnet import PaddedConv2d
from creste_public_tpu_torch.models.distillation import DistillationBackbone
from creste_public_tpu_torch.ops import splat as splat_ops
from creste_public_tpu_torch.utils import depth as du
from creste_public_tpu_torch.utils import geometry as geo

SPATIAL_AXIS = "x"
# columns of the reward head's input view fetched on either side of a
# rank's own: its receptive field reaches 7 columns in at the strip's edge
# (5x5 and 3x3 prepool, 3x3 skip, 2x2 pool, 3x3 trunk at half resolution,
# bilinear x2), and a strip starts and ends on an even column so that the
# pool and the upsample see the frame's pairs
HEAD_HALO = 8


def partition(width: int, n: int) -> list[tuple[int, int]]:
    """The columns ``[lo, hi)`` of each of ``n`` ranks in a dimension of
    ``width``: ``ceil(width / n)`` each, the last ones clipped (GSPMD's
    split; a rank may own none)."""
    c = -(-width // n)
    return [(min(r * c, width), min((r + 1) * c, width)) for r in range(n)]


@dataclass(frozen=True)
class SpatialMesh:
    """A 1-D mesh of ``size`` ranks over the axis ``SPATIAL_AXIS``:
    ``group`` (None: one rank, every collective the identity) and this
    process's ``rank`` in it (-1: not a member)."""

    group: Any
    size: int
    rank: int

    def partition(self, width: int) -> list[tuple[int, int]]:
        return partition(width, self.size)

    def columns(self, width: int) -> tuple[int, int]:
        """This rank's columns of a dimension of ``width``."""
        return self.partition(width)[self.rank]

    def all_gather(self, t: torch.Tensor) -> list[torch.Tensor]:
        if self.group is None:
            return [t]
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t.contiguous(), group=self.group)
        return parts

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``t`` summed (``op`` "sum") or maximised ("max") over the ranks,
        in place."""
        if self.group is not None:
            dist.all_reduce(t, op=dist.ReduceOp.MAX if op == "max"
                            else dist.ReduceOp.SUM, group=self.group)
        return t


def make_spatial_mesh(num_devices: int | None = None,
                      group: Any = None) -> SpatialMesh:
    """The spatial mesh over the first ``num_devices`` ranks of ``group``
    (the default group when a process group is up; else this one process),
    all of them by default. Raises ``ValueError`` when the group has fewer
    ranks than asked, as the JAX package's does: a silent truncation would
    misreport the latency-scaling factor. Fewer ranks than the group's
    make a subgroup (every rank of ``group`` must call this); a rank left
    out gets a mesh with ``rank`` -1."""
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    world = dist.get_world_size(group) if group is not None else 1
    n = num_devices or world
    if n > world:
        raise ValueError(
            f"spatial mesh needs {n} ranks, have {world} — a silent "
            "truncation would misreport the latency-scaling factor")
    if group is None:
        return SpatialMesh(None, 1, 0)
    rank = dist.get_rank(group)
    if n < world:
        group = dist.new_group(
            [dist.get_global_rank(group, i) for i in range(n)])
        rank = rank if rank < n else -1
    return SpatialMesh(group, n, rank)


class Replicated(NamedTuple):
    """Every rank holds the whole tensor."""

    def shard(self, t: torch.Tensor, mesh: SpatialMesh) -> torch.Tensor:
        return t


class Columns(NamedTuple):
    """Axis ``axis`` split over the mesh: rank r holds ``ranges[r]``."""

    axis: int
    ranges: tuple[tuple[int, int], ...]

    def shard(self, t: torch.Tensor, mesh: SpatialMesh) -> torch.Tensor:
        lo, hi = self.ranges[mesh.rank]
        return t.narrow(self.axis, lo, hi - lo)


def spatial_inference_shardings(mesh: SpatialMesh, width: int
                                ) -> tuple[Replicated, Columns, Replicated]:
    """The placement of (weights, rgbd, p2p) for a frame ``width`` columns
    wide: weights and p2p replicated, the RGBD width ([B, V, H, W, C],
    axis 3) split over the mesh (``Columns.ranges``: the columns each
    rank owns)."""
    return (Replicated(), Columns(3, tuple(mesh.partition(width))),
            Replicated())


class Strip(NamedTuple):
    """This rank's columns (the last dimension) of an NCHW tensor
    ``width`` columns wide."""

    t: torch.Tensor
    width: int


class Cols(NamedTuple):
    """An output sharded along ``dim`` (``width`` wide in all), reshaped
    to ``shape`` once gathered (None: as gathered)."""

    t: torch.Tensor
    width: int
    dim: int
    shape: tuple | None = None


def _empty(like: torch.Tensor, *shape: int, dtype=None) -> torch.Tensor:
    return like.new_zeros(shape, dtype=dtype or like.dtype)


def fetch(x: Strip, need: Sequence[tuple[int, int]],
          mesh: SpatialMesh) -> torch.Tensor:
    """Columns ``need[rank]`` (``[a, b)`` in global coordinates, which may
    run past either edge of the frame: zeros there) of the sharded ``x``,
    as one tensor [..., b - a]. ``need`` holds every rank's range (each
    rank computes the same plan). Columns owned by other ranks, adjacent
    or not, come through one ``all_gather`` of each rank's two slabs: the
    columns that lower ranks need from it and those that higher ranks
    need; none when every rank reads only its own columns."""
    parts = mesh.partition(x.width)
    r, n = mesh.rank, mesh.size
    a, b = need[r]
    lo, hi = parts[r]
    if all(p[0] <= q[0] and q[1] <= p[1] or q[0] >= q[1]
           for p, q in zip(parts, need)):
        return x.t[..., a - lo:b - lo] if a < b else x.t[..., :0]

    def hull(src: int, dsts) -> tuple[int, int]:
        slo, shi = parts[src]
        c0, c1 = shi, slo
        for d in dsts:
            j0, j1 = max(need[d][0], slo), min(need[d][1], shi)
            if j0 < j1:
                c0, c1 = min(c0, j0), max(c1, j1)
        return (c0, c1) if c0 < c1 else (slo, slo)

    down = [hull(s, range(s)) for s in range(n)]  # sent to lower ranks
    up = [hull(s, range(s + 1, n)) for s in range(n)]  # to higher ranks
    md = max(c1 - c0 for c0, c1 in down)
    mu = max(c1 - c0 for c0, c1 in up)
    lead = x.t.shape[:-1]
    if md + mu:  # (else only the frame's padding lies outside)
        send = _empty(x.t, *lead, md + mu)
        for off, (c0, c1) in ((0, down[r]), (md, up[r])):
            send[..., off:off + c1 - c0] = x.t[..., c0 - lo:c1 - lo]
        got = mesh.all_gather(send)
    out = _empty(x.t, *lead, max(b - a, 0))
    for s, (slo, shi) in enumerate(parts):
        j0, j1 = max(a, slo), min(b, shi)
        if j0 >= j1:
            continue
        if s == r:
            out[..., j0 - a:j1 - a] = x.t[..., j0 - lo:j1 - lo]
        else:
            off, (c0, _) = (0, down[s]) if s > r else (md, up[s])
            out[..., j0 - a:j1 - a] = got[s][..., off + j0 - c0:off + j1 - c0]
    return out


def conv2d(x: Strip, weight: torch.Tensor, bias: torch.Tensor | None,
           stride: Sequence[int], pad: Sequence[int], groups: int,
           mesh: SpatialMesh) -> Strip:
    """``F.conv2d`` of the frame with ``pad`` = (top, bottom, left, right)
    zeros around it, on this rank's output columns."""
    top, bottom, left, right = pad
    kh, kw = weight.shape[-2:]
    sh, sw = stride
    wout = (x.width + left + right - kw) // sw + 1
    parts = mesh.partition(wout)
    need = [(o0 * sw - left, (o1 - 1) * sw - left + kw) if o1 > o0
            else (0, 0) for o0, o1 in parts]
    xs = fetch(x, need, mesh)
    xs, w, b = promoted(xs, weight, bias)
    o0, o1 = parts[mesh.rank]
    if o0 == o1:
        B, _, H = xs.shape[:3]
        return Strip(_empty(xs, B, w.shape[0], (H + top + bottom - kh) // sh
                            + 1, 0), wout)
    if top or bottom:
        xs = F.pad(xs, (0, 0, top, bottom))
    return Strip(F.conv2d(xs, w, b, (sh, sw), 0, 1, groups), wout)


def conv(m: torch.nn.Conv2d, x: Strip, mesh: SpatialMesh) -> Strip:
    """A port convolution module (``Conv2d`` or ``PaddedConv2d``) on the
    strip, with the module's padding."""
    if tuple(m.dilation) != (1, 1) or isinstance(m.padding, str):
        raise NotImplementedError("dilated or string-padded convolution")
    if isinstance(m, PaddedConv2d):
        left, right, top, bottom = m.pad
    else:
        (top, left) = m.padding
        bottom, right = top, left
    return conv2d(x, m.weight, m.bias, m.stride, (top, bottom, left, right),
                  m.groups, mesh)


def max_pool2d(x: Strip, k: int, s: int, mesh: SpatialMesh) -> Strip:
    """``F.max_pool2d(x, k, s)`` of the frame, on this rank's columns."""
    wout = (x.width - k) // s + 1
    parts = mesh.partition(wout)
    need = [(o0 * s, (o1 - 1) * s + k) if o1 > o0 else (0, 0)
            for o0, o1 in parts]
    xs = fetch(x, need, mesh)
    o0, o1 = parts[mesh.rank]
    if o0 == o1:
        B, C, H = xs.shape[:3]
        return Strip(_empty(xs, B, C, (H - k) // s + 1, 0), wout)
    return Strip(F.max_pool2d(xs, k, s), wout)


def _source_columns(win: int, wout: int, o0: int, o1: int):
    """Bilinear sampling (half-pixel centres, as ``F.interpolate`` with
    ``align_corners=False``) of output columns [o0, o1) from ``win``
    input columns, as torch's kernels compute it: the position
    ``fma(win / wout, o + 0.5, -0.5)`` in f32, then the left and right
    source columns and the right weight."""
    scale = np.float32(win) / np.float32(wout)
    src = (np.float64(scale) * (np.arange(o0, o1) + 0.5) - 0.5).astype(
        np.float32)
    src = np.maximum(src, np.float32(0))
    i0 = np.minimum(np.floor(src).astype(np.int64), win - 1)
    lam = np.clip(src - i0.astype(np.float32), 0, 1).astype(np.float32)
    return i0, i0 + (i0 < win - 1), lam


def resize_bilinear(x: Strip, size: Sequence[int],
                    mesh: SpatialMesh) -> Strip:
    """``convnets.resize_bilinear`` of the frame to ``size`` (global H and
    W), on this rank's output columns: each output column samples the
    frame's columns at its global half-pixel position (the two it reads
    fetched from their owners) as ``fma(left, 1 - w, right * w)``, then
    the rows are resized as on one rank: the order and the rounding of
    torch's kernel, equal to it on the card at the graph's sizes and on
    the CPU at its larger ones. A bf16 strip is resized in f32 and
    rounded once, as torch's kernel does."""
    ho, wout = int(size[0]), int(size[1])
    parts = mesh.partition(wout)
    cols = [_source_columns(x.width, wout, o0, o1) for o0, o1 in parts]
    need = [(int(i0[0]), int(i1[-1]) + 1) if len(i0) else (0, 0)
            for i0, i1, _ in cols]
    xs = fetch(x, need, mesh)
    i0, i1, lam = cols[mesh.rank]
    B, C = xs.shape[:2]
    if not len(i0):
        return Strip(_empty(xs, B, C, ho, 0), wout)
    a = need[mesh.rank][0]
    dev = xs.device
    acc = _accumulator(xs.dtype)
    w1 = torch.from_numpy(lam).to(dev)
    left = xs.index_select(-1, torch.from_numpy(i0 - a).to(dev)).to(acc)
    right = xs.index_select(-1, torch.from_numpy(i1 - a).to(dev)).to(acc)
    # f64 holds the product exactly: one rounding, as a fused multiply-add
    y = (left.double() * (1 - w1).double() + (right * w1).double()).to(acc)
    if y.shape[-2] != ho:
        y = F.interpolate(y, size=(ho, y.shape[-1]), mode="bilinear",
                          align_corners=False)
    return Strip(y.to(xs.dtype), wout)


def _accumulator(dtype: torch.dtype) -> torch.dtype:
    """The dtype torch's resize and mean kernels accumulate ``dtype`` in:
    f32 for bf16 and f16 (rounded once at the end), else ``dtype``."""
    return torch.promote_types(dtype, torch.float32)


def mean_hw(x: Strip, mesh: SpatialMesh) -> torch.Tensor:
    """The mean over the frame's H and W [B, C, 1, 1] on every rank: the
    strips' sums, in the dtype the one-rank ``mean`` accumulates in (f32
    for a bf16 strip), all-reduced, then divided by the global H * W."""
    acc = _accumulator(x.t.dtype)
    s = mesh.all_reduce(x.t.to(acc).sum(dim=(2, 3), keepdim=True))
    return (s / (x.t.shape[2] * x.width)).to(x.t.dtype)


def gather_columns(t: torch.Tensor, width: int, dim: int,
                   mesh: SpatialMesh) -> torch.Tensor:
    """The whole tensor from every rank's columns ``dim`` of it (``width``
    in all), on every rank."""
    if mesh.size == 1:
        return t
    dim = dim % t.dim()
    parts = mesh.partition(width)
    c = max(hi - lo for lo, hi in parts)
    dtype = t.dtype
    t = t.movedim(dim, -1)
    if dtype == torch.bool:  # (gloo has no bool)
        t = t.to(torch.uint8)
    pad = _empty(t, *t.shape[:-1], c)
    pad[..., :t.shape[-1]] = t
    got = mesh.all_gather(pad)
    full = torch.cat([g[..., :hi - lo] for g, (lo, hi) in zip(got, parts)],
                     dim=-1)
    return full.movedim(-1, dim).to(dtype)


# --- the port's modules on strips ---


def _map(x: Strip, f) -> Strip:
    """A per-pixel function of the strip."""
    return Strip(f(x.t), x.width)


def _cat(xs: Sequence[Strip]) -> Strip:
    return Strip(torch.cat([x.t for x in xs], dim=1), xs[0].width)


def multi_layer_conv(m: MultiLayerConv, x: Strip,
                     mesh: SpatialMesh) -> Strip:
    for i in range(m.n):
        x = conv(getattr(m, f"Conv_{i}"), x, mesh)
        if m.norm:
            x = _map(x, getattr(m, f"BatchNorm_{i}"))
        x = _map(x, F.relu)
    return x


def conv_layer(m: ConvLayer, x: Strip, mesh: SpatialMesh) -> Strip:
    x = conv(m.Conv_0, x, mesh)
    if m.norm is not None:
        x = _map(x, getattr(m, m.norm))
    return _map(x, F.relu) if m.relu else x


def mbconv(m, x: Strip, mesh: SpatialMesh) -> Strip:
    """``effnet.MBConvBlock`` in eval: squeeze-excitation on the frame's
    mean."""
    inp = x
    if m.expand:
        x = _map(conv(m.expand_conv, x, mesh),
                 lambda t: F.silu(m.bn0(t)))
    x = _map(conv(m.depthwise_conv, x, mesh), lambda t: F.silu(m.bn1(t)))
    se = m.se_expand(F.silu(m.se_reduce(mean_hw(x, mesh))))
    x = _map(x, lambda t: torch.sigmoid(se) * t)
    x = _map(conv(m.project_conv, x, mesh), m.bn2)
    if m.residual:
        x = Strip(x.t + inp.t, x.width)
    return x


def up(m, x1: Strip, x2: Strip, mesh: SpatialMesh) -> Strip:
    """``effnet.Up``: x1 resized to x2's size, [x2, x1], two conv + BN +
    ReLU."""
    x1 = resize_bilinear(x1, (x2.t.shape[-2], x2.width), mesh)
    x = _cat([x2, x1])
    x = _map(conv(m.conv_0, x, mesh), lambda t: F.relu(m.bn_0(t)))
    return _map(conv(m.conv_1, x, mesh), lambda t: F.relu(m.bn_1(t)))


def effnet(m, x: Strip, mesh: SpatialMesh) -> tuple[Strip, Strip]:
    """``effnet.EffNet`` in eval: (the projected map, the decoder
    tensor)."""
    tr = m.trunk
    h = _map(conv(tr.conv_stem, x, mesh), lambda t: F.silu(tr.bn0(t)))
    if tr.compute_dtype is not None:  # the stream after the f32 stem
        h = _map(h, lambda t: t.to(tr.compute_dtype))
    endpoints: dict[str, Strip] = {}
    prev = h
    for idx in range(tr.n_blocks):
        h = mbconv(getattr(tr, f"block_{idx}"), h, mesh)
        if prev.t.shape[2] > h.t.shape[2]:
            endpoints[f"reduction_{len(endpoints) + 1}"] = prev
        elif idx == tr.n_blocks - 1:
            endpoints[f"reduction_{len(endpoints) + 1}"] = h
        prev = h
    endpoints["reduction_0"] = x
    y = endpoints["reduction_5"]
    for i in range(1, m.n_up + 1):
        y = up(getattr(m, f"up{i}"), y, endpoints[f"reduction_{5 - i}"], mesh)
    return conv(m.conv, y, mesh), y


def _nhwc(x: Strip, shape: tuple | None = None) -> Cols:
    return Cols(x.t.permute(0, 2, 3, 1), x.width, 2, shape)


def predict_depth(m, feats: Strip, mesh: SpatialMesh) -> dict[str, Cols]:
    """``DepthCompletion.predict_depth`` on the trunk's feature strip
    [B, Z, Hs, ws]: the depth head (reading a bf16 stream in f32), then
    the metric depth and the bins per pixel."""
    disc = m.cfg["discretize"]
    if m.compute_dtype is not None:
        feats = _map(feats, lambda t: t.float())
    logits = multi_layer_conv(m.depth_head, feats, mesh)
    lg = logits.t.permute(0, 2, 3, 1)
    metric_mm = du.metric_depth_from_logits(
        lg, disc["mode"], float(disc["depth_min"]), float(disc["depth_max"]),
        int(disc["num_bins"]))
    w = logits.width
    return {"depth_preds_logits": Cols(lg, w, 2),
            "depth_preds_metric": Cols(metric_mm / 1000.0, w, 2),
            "depth_preds_bins": Cols(lg.argmax(dim=-1).to(torch.int32), w,
                                     2)}


def depth_completion(m, x: Strip, mesh: SpatialMesh
                     ) -> tuple[dict[str, Cols], Strip]:
    """``DepthCompletion`` on frames [B, C, H, W] (NCHW strips): its
    outputs, and the features as a strip."""
    feats = effnet(m.vision_backbone.effnet, x, mesh)[0]
    out = predict_depth(m, feats, mesh)
    if m.cfg["vision_backbone"].get("return_feats", True):
        out["depth_preds_feats"] = _nhwc(feats)
    return out, feats


def backbone(m, rgbd: torch.Tensor, width: int, mesh: SpatialMesh
             ) -> dict[str, Cols]:
    """TerrainNet's image backbone (a ``DistillationBackbone`` without
    stage 1's PE map and multiview splat, in f32 or a bf16 stream) on
    this rank's columns of rgbd [B, V, H, W, 4] (``width`` in all)."""
    if (not isinstance(m, DistillationBackbone) or m.cam2map is not None
            or m.learnable_pe_map is not None):
        raise NotImplementedError(
            "spatial inference runs the deployment graph's backbone (a "
            "DistillationBackbone without stage 1's PE map and multiview "
            "splat, which no deployment graph runs)")
    B, V, H, W, C = rgbd.shape
    x = Strip(rgbd.reshape(B * V, H, W, C).permute(0, 3, 1, 2).contiguous(),
              width)
    out, feats = depth_completion(m.depthcomp, x, mesh)
    out["dino_pe_feats"] = dino_head(m, feats, B, V, mesh)
    return out


def dino_head(m, feats: Strip, B: int, V: int, mesh: SpatialMesh) -> Cols:
    """``DistillationBackbone``'s DINO head on the trunk's feature strip of
    B * V frames: ``dino_pe_feats`` [B, V, Hs, ws, D]."""
    dino = multi_layer_conv(m.dino_head, feats, mesh)
    return Cols(dino.t.permute(0, 2, 3, 1).reshape(
        B, V, *dino.t.shape[2:], -1), dino.width, 3)


def cam2map(m, depth: torch.Tensor, feats: torch.Tensor, p2p: torch.Tensor,
            width: int, mesh: SpatialMesh) -> dict[str, Any]:
    """``Camera2MapMulti`` (eval) on this rank's columns of depth
    [B, N, H, W] and feats [B, N, H, W, F] (``width`` in all): every rank
    splats its own pixels into full-grid sums and densities, the sums are
    all-reduced, then divided (``mean``, ``sum``); in ``max`` mode every
    rank takes its pixels' maxima over a zero grid, as the one-rank splat
    does, and the grids are all-reduced by their maximum (max is
    associative and every grid starts at the same zeros: the one-rank
    grid to the bit), the densities summed. Every rank holds the whole
    ``bev_features`` and ``bev_densities``; ``bev_coords`` stays sharded
    (a ``Cols`` in the one-rank pixel order once gathered)."""
    B, N, H, W = depth.shape
    lo, _ = mesh.columns(width)
    xyz = geo.backproject_depth(depth, p2p, col0=lo)
    z_feats = m.z_proj(xyz[..., 2:3].to(feats.dtype))
    fused = torch.cat([feats, z_feats], dim=-1).reshape(B * N, H, W, -1)
    fused = multi_layer_conv(m.vision_fusion, Strip(
        fused.permute(0, 3, 1, 2).contiguous(), width), mesh).t
    fused = fused.permute(0, 2, 3, 1).reshape(B, N, H, W, -1)
    C = fused.shape[-1]
    g = xyz.dtype
    mask = geo.point_in_range_mask(xyz, m.min_bound.to(g),
                                   m.max_bound.to(g))
    fused = fused * mask[..., None]
    if N % m.nc:
        raise ValueError(f"Number of frames must be divisible by {m.nc}")
    ns = N // m.nc
    xy = geo.points_to_voxels(xyz, m.l2m.to(g), m.voxel_xy.to(g))
    pts = (xy.reshape(B * ns, m.nc * H * W, 2),
           fused.reshape(B * ns, m.nc * H * W, C), m.grid_hw)
    if m.scatter_mode == "max":
        f, d = splat_ops.splat_max(*pts)
        f = mesh.all_reduce(f, "max").to(fused.dtype)
        mesh.all_reduce(d)
    else:
        acc = mesh.all_reduce(splat_ops.splat_sums(*pts))
        f, d = splat_ops.finish_splat(acc, m.scatter_mode, 1.0, fused.dtype)
    Hg, Wg = m.grid_hw
    return {"bev_features": f.reshape(B * ns, Hg, Wg, C),
            "bev_densities": d.reshape(B * ns, Hg, Wg, 1),
            "bev_coords": Cols(xy.reshape(B * ns, m.nc, H, W, 2), width, 3,
                               (B * ns, m.nc * H * width, 2))}


def basic_block(m, x: Strip, mesh: SpatialMesh) -> Strip:
    out = _map(conv(m.conv1, x, mesh), lambda t: F.relu(m.bn1(t)))
    out = _map(conv(m.conv2, out, mesh), m.bn2)
    identity = _map(conv(m.down_conv, x, mesh), m.down_bn) if m.down else x
    return Strip(F.relu(out.t + identity.t), out.width)


def decoder(m, bev: torch.Tensor, mesh: SpatialMesh
            ) -> tuple[dict[str, Cols], dict[str, Strip]]:
    """``InpaintingResNet18MultiHead`` (eval, its heads one by one or
    merged) on this rank's columns of the whole grid ``bev`` [B, Hg, Wg,
    C] (NHWC): the outputs as ``Cols`` and the heads' predictions as NCHW
    strips (by output key)."""
    Wg = bev.shape[2]
    lo, hi = mesh.columns(Wg)
    x = Strip(bev[:, :, lo:hi].permute(0, 3, 1, 2).contiguous(), Wg)
    x = _map(conv(m.conv1, x, mesh), lambda t: F.relu(m.bn1(t)))
    x = basic_block(m.layer1_1, basic_block(m.layer1_0, x, mesh), mesh)
    x1 = x
    x = basic_block(m.layer2_1, basic_block(m.layer2_0, x, mesh), mesh)
    x = basic_block(m.layer3_1, basic_block(m.layer3_0, x, mesh), mesh)
    heads = merged_heads(m, x, x1, mesh) if m.merged_heads else []
    for i in range(0 if m.merged_heads else len(m.num_classes)):
        h = getattr(m, f"head_{i}")
        y = up(h.up1, x, x1, mesh)
        y = resize_bilinear(y, (y.t.shape[-2] * 2, y.width * 2), mesh)
        y = _map(conv(h.up2_conv, y, mesh), lambda t, h=h: F.relu(
            h.up2_bn(t)))
        heads.append((conv(h.proj, y, mesh), y))
    out: dict[str, Any] = {}
    strips: dict[str, Strip] = {}
    for p, (preds, fea) in zip(m.output_prefix, heads):
        out[f"{p}_preds"] = _nhwc(preds)
        out[f"{p}_features"] = _nhwc(fea)
        strips[f"{p}_preds"] = preds
    if m.log_var is not None:
        out["log_variance"] = m.log_var
    return out, strips


def merged_heads(m, x: Strip, x1: Strip, mesh: SpatialMesh
                 ) -> list[tuple[Strip, Strip]]:
    """``InpaintingResNet18MultiHead._merged`` on strips: the heads' first
    convolution as one (``mh_conv0``), the later ones grouped by head
    (``mh_conv1``, ``mh_up2``), one resize per layer and the
    block-diagonal projection (``mh_proj``), split into each head's
    (preds, features) as the module splits them."""
    y = _cat([x1, resize_bilinear(x, (x1.t.shape[-2], x1.width), mesh)])
    y = _map(conv(m.mh_conv0, y, mesh), lambda t: F.relu(m.mh_bn0(t)))
    y = _map(conv(m.mh_conv1, y, mesh), lambda t: F.relu(m.mh_bn1(t)))
    y = resize_bilinear(y, (y.t.shape[-2] * 2, y.width * 2), mesh)
    y = _map(conv(m.mh_up2, y, mesh), lambda t: F.relu(m.mh_up2_bn(t)))
    preds = conv(m.mh_proj, y, mesh)
    offs = np.cumsum([0] + m.num_classes)
    return [(_map(preds, lambda t, i=i: t[:, offs[i]:offs[i + 1]]),
             _map(y, lambda t, i=i: t[:, i * 128:(i + 1) * 128]))
            for i in range(len(m.num_classes))]


def msfcn(m, x: Strip, mesh: SpatialMesh) -> Strip:
    """``convnets.MultiScaleFCN`` (eval) on the strip."""
    for i in range(m.n_prepool):
        x = conv_layer(getattr(m, f"prepool_{i}"), x, mesh)
    skip = x
    for i in range(m.n_skip):
        skip = conv_layer(getattr(m, f"skip_{i}"), skip, mesh)
    t = max_pool2d(x, 2, 2, mesh)
    for i in range(m.n_trunk):
        t = conv_layer(getattr(m, f"trunk_{i}"), t, mesh)
        if m.trunk_bn:
            t = _map(t, lambda v, i=i: F.relu(getattr(m, f"trunk_bn_{i}")(v)))
    t = resize_bilinear(t, (int(t.t.shape[-2] * 2), int(t.width * 2)), mesh)
    x = _cat([t, skip])
    for i in range(m.n_postpool):
        x = conv_layer(getattr(m, f"postpool_{i}"), x, mesh)
    return x


def head_strip_columns(width: int, mesh: SpatialMesh
                       ) -> list[tuple[int, int]]:
    """Each rank's columns of the reward head's input view (``width``
    wide, even) that it runs the fused head on: its own widened by
    ``HEAD_HALO`` on either side, starting and ending on an even column,
    clipped to the frame ((0, 0) for a rank that owns none)."""
    if width % 2:
        raise ValueError(f"the fused head runs across ranks on an even "
                         f"input-view width, got {width}")
    cols = []
    for a, b in mesh.partition(width):
        if a == b:
            cols.append((0, 0))
            continue
        s = max(0, a - HEAD_HALO)
        e = min(width, b + HEAD_HALO)
        cols.append((s - s % 2, e + e % 2))
    return cols


def fused_head(tensors: list[torch.Tensor], iv: Strip,
               mesh: SpatialMesh) -> Strip:
    """The folded reward head (``creste::msfcn_head``: the kernel on the
    card, its plain version on the CPU), once on this rank's padded strip
    of the input view (``head_strip_columns``), cropped to its own
    columns."""
    need = head_strip_columns(iv.width, mesh)
    xs = fetch(iv, need, mesh)
    a, b = mesh.columns(iv.width)
    B, _, h = xs.shape[:3]
    if a == b:
        return Strip(_empty(xs, B, 1, h, 0, dtype=torch.float32), iv.width)
    s = need[mesh.rank][0]
    r = torch.ops.creste.msfcn_head(
        xs.permute(0, 2, 3, 1).float().contiguous(), tensors)
    return Strip(r[:, :, a - s:b - s].permute(0, 3, 1, 2), iv.width)


def reward(vin, maps: dict[str, Strip], mesh: SpatialMesh,
           head_tensors: list[torch.Tensor] | None) -> dict[str, Cols]:
    """``VIN`` without the MDP solve on the decoder's prediction strips
    (``maps``): the input view (max-pool by ``ds``, the front half of the
    rows, in f32), then ``reward_from_view``."""
    rc = vin.reward_cfg
    keys, ds = rc["input_keys"], int(rc["ds"])
    x = max_pool2d(_cat([maps[k] for k in keys]), ds, ds, mesh)
    iv = _map(x, lambda t: t[:, :, :t.shape[2] // 2].float())
    m0 = maps[keys[0]]
    out = reward_from_view(vin, iv, (m0.t.shape[2], m0.width), mesh,
                           head_tensors)
    out["input_view"] = _nhwc(iv)
    return out


def reward_from_view(vin, iv: Strip, size: tuple[int, int],
                     mesh: SpatialMesh,
                     head_tensors: list[torch.Tensor] | None
                     ) -> dict[str, Cols]:
    """The reward of the input view's strip ``iv`` (``head_tensors``: the
    folded head, fused; None: the unfused ``MultiScaleFCN``) and its
    full-size map, the size (rows, columns) of the maps the view was
    pooled from."""
    Ho, Wo = size
    r = (fused_head(head_tensors, iv, mesh) if head_tensors is not None
         else msfcn(vin.r, iv, mesh))
    top = resize_bilinear(r, (Ho // 2, Wo), mesh).t
    full = torch.cat([top, top.new_zeros(*top.shape[:2], Ho - Ho // 2,
                                         top.shape[-1])], dim=2)
    prefix = vin.reward_cfg["output_prefix"][0]
    return {prefix: _nhwc(r), f"{prefix}_full": _nhwc(Strip(full, Wo))}


def deployment_graph(model, rgbd: torch.Tensor, p2p: torch.Tensor,
                     width: int, mesh: SpatialMesh,
                     head_tensors: list[torch.Tensor] | None
                     ) -> dict[str, Any]:
    """``MaxEntIRL`` without the MDP solve (eval) on this rank's columns
    of rgbd [B, N, H, W, 4] (``width`` in all): every output, each whole
    (a tensor) or sharded (a ``Cols``). ``head_tensors``: the folded
    reward head (``reward_kernel.head_tensors``), or None for the unfused
    one."""
    tn = model.backbone
    if model.training:
        raise NotImplementedError(
            "spatial inference runs the eval deployment graph, not training "
            "mode (train-mode BatchNorms would need the frame's statistics "
            "across ranks)")
    if tn.use_temporal:
        raise NotImplementedError(
            "spatial inference does not split the temporal merge (no "
            "inference config runs it)")
    if not tn.has_decoder:
        raise NotImplementedError(
            "spatial inference needs the BEV decoder the reward reads")
    B, N = rgbd.shape[:2]
    outputs = backbone(tn.depthcomp, rgbd, width, mesh)
    feats = outputs[tn.splat_key]
    Hs, ws, Z = feats.t.shape[-3:]
    outputs.update(bev_graph(
        model, outputs["depth_preds_metric"].t.reshape(B, N, Hs, ws),
        feats.t.reshape(B, N, Hs, ws, Z), p2p, feats.width, mesh,
        head_tensors))
    return outputs


def bev_graph(model, depth: torch.Tensor, feats: torch.Tensor,
              p2p: torch.Tensor, width: int, mesh: SpatialMesh,
              head_tensors: list[torch.Tensor] | None) -> dict[str, Any]:
    """The deployment graph after the image backbone, from this rank's
    columns of the metric depth [B, N, Hs, ws] and the features
    [B, N, Hs, ws, Z] (``width`` in all): the splat, the BEV decoder and
    the reward."""
    outputs = cam2map(model.backbone.cam2map, depth, feats, p2p, width,
                      mesh)
    outputs.update(bev_heads(model, outputs[
        model.backbone.bevclassifier.input_key], mesh, head_tensors))
    return outputs


def bev_heads(model, bev: torch.Tensor, mesh: SpatialMesh,
              head_tensors: list[torch.Tensor] | None) -> dict[str, Any]:
    """The BEV decoder and the reward on this rank's columns of the whole
    splat grid ``bev`` [B, Hg, Wg, C]."""
    outputs, maps = decoder(model.backbone.bevclassifier, bev, mesh)
    outputs.update(reward(model.traversability_head, maps, mesh,
                          head_tensors))
    return outputs


def gather_outputs(outputs: dict[str, Any], mesh: SpatialMesh,
                   keys: Sequence[str] | None = None
                   ) -> dict[str, torch.Tensor]:
    """The outputs (``keys`` of them, every one by default) in the
    one-rank layout on every rank: each ``Cols`` gathered, in sorted key
    order on every rank."""
    out = {}
    for k in sorted(keys if keys is not None else outputs):
        v = outputs[k]
        if isinstance(v, Cols):
            g = gather_columns(v.t, v.width, v.dim, mesh)
            v = g.reshape(v.shape) if v.shape is not None else g
        out[k] = v
    return out
