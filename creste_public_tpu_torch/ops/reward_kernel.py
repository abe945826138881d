"""Inference-mode MultiScaleFCN reward head with every BN folded, on a
hand-written CUDA kernel.

Counterpart of ``creste_public_tpu/ops/reward_pallas.py``. At inference each
BatchNorm is a per-channel ``a * x + b``, so every layer of the head is one
conv + affine (+ the trunk's relu before its BN, + relu after). On CUDA
tensors the whole head is four launches of ``csrc/msfcn_chain.cu``, its
convolutions on tensor cores in 3xTF32, with the 2x2 maxpool, the bilinear
upsample and the concat folded into them and no PyTorch op between them.
On CPU tensors the same function runs its plain PyTorch version. Inference
only: no backward.

The head is also the operator ``creste::msfcn_head`` (``torch.library``),
so that ``torch.export`` traces a graph through it and a reloaded program
calls it: its CUDA implementation is the kernel's launch, its CPU
implementation the plain version, and its fake implementation gives the
output's shape. The folded weights cross the operator's boundary as a list
of tensors (``head_tensors``). Importing this module registers the
operator. Weights rounded to bf16 fold in f32 from their rounded values,
and the kernel reads its input in f32.
"""
from __future__ import annotations

import ctypes
import functools
from collections.abc import Callable, Iterator, Mapping
from types import MappingProxyType

import torch
import torch.nn.functional as F

from creste_public_tpu_torch.models.blocks.convnets import (
    MultiScaleFCN,
    resize_bilinear,
)
from creste_public_tpu_torch.ops import _build

Layer = dict  # {"kernel" [kh,kw,Ci,Co], "a" [Co], "b" [Co], "pre_relu", "post_relu"}


# The head the kernel runs: per chain, per layer (kernel size, Ci, Co,
# pre_relu); None = any (the first layer's kernel size is odd and <= 5, its
# Ci the input view's, a multiple of 8 up to 64). Mirrors kC1..kC6 of
# csrc/msfcn_chain.cu.
HEAD = {
    "prepool": [(None, None, 64, False), (3, 64, 32, False)],
    "skip": [(3, 32, 32, False), (1, 32, 16, False)],
    "trunk": [(3, 32, 32, True), (1, 32, 32, True)],
    "postpool": [(1, 48, 1, False)],
}
_TENSOR_CORE_CHAINS = ("prepool", "skip", "trunk")
LAUNCHES_PER_HEAD = 4


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: f32 rounded to nearest (ties away from zero)
    at 10 mantissa bits, the low 13 bits zero; on any device."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def pack_tf32_fragments(kernel: torch.Tensor) -> torch.Tensor:
    """HWIO weights [kh, kw, Ci, Co] (Ci, Co multiples of 8) split as
    hi = tf32(w), lo = tf32(w - hi) and packed as the mma.m16n8k8 B
    fragments: [tap, Ci/8, Co/8, lane, (b0 hi, b1 hi, b0 lo, b1 lo)], lane
    = 4 * n + k, b0 = w[k], b1 = w[k + 4] (k, n within the 8x8 block),
    flat."""
    kh, kw, ci, co = kernel.shape
    w = kernel.float().reshape(kh * kw, ci // 8, 8, co // 8, 8)
    hi = tf32_round(w)
    lo = tf32_round(w - hi)

    def frag(v):  # [tap, ks, k, nt, n] -> [tap, ks, nt, n, k]
        v = v.permute(0, 1, 3, 4, 2)
        return v[..., :4], v[..., 4:]

    (h0, h1), (l0, l1) = frag(hi), frag(lo)
    return torch.stack([h0, h1, l0, l1], dim=-1).reshape(-1).contiguous()


def _fold(conv: torch.nn.Conv2d, bn, pre_relu: bool,
          tensor_cores: bool) -> Layer:
    w = conv.weight.detach().float()
    a = bn.weight.detach().float() / torch.sqrt(
        bn.running_var.detach().float() + bn.eps)
    b = bn.bias.detach().float() - bn.running_mean.detach().float() * a
    layer = {
        "kernel": w.permute(2, 3, 1, 0).contiguous(),  # OIHW -> HWIO
        "a": a.contiguous(),
        "b": b.contiguous(),
        "pre_relu": pre_relu,
        "post_relu": True,
    }
    if tensor_cores and w.shape[0] % 8 == 0 and w.shape[1] % 8 == 0:
        layer["packed"] = pack_tf32_fragments(layer["kernel"])
    return layer


class FoldedHead(Mapping):
    """A folded head, read-only: chain name -> tuple of layers, each a
    read-only mapping of ``Layer``'s keys (and ``packed``). Because it
    cannot be changed, it keeps, per device, the kernel's checked weight
    pointers (``kernel_args``)."""

    def __init__(self, chains: Mapping[str, list[Layer]]):
        self._chains = {k: tuple(MappingProxyType(dict(ly)) for ly in v)
                        for k, v in chains.items()}
        self._kernel_args: dict[torch.device, tuple] = {}

    def __getitem__(self, chain: str) -> tuple[Mapping, ...]:
        return self._chains[chain]

    def __iter__(self) -> Iterator[str]:
        return iter(self._chains)

    def __len__(self) -> int:
        return len(self._chains)

    def to(self, device) -> FoldedHead:
        """A copy with every tensor on ``device``."""
        return FoldedHead({
            k: [{n: t.to(device) if isinstance(t, torch.Tensor) else t
                 for n, t in ly.items()} for ly in v]
            for k, v in self._chains.items()})

    def kernel_args(self, device: torch.device) -> tuple[int, int, tuple]:
        """(k0, Ci, the weight pointers in the kernel's order) on
        ``device``, checked by ``_head_weights`` on the first call."""
        args = self._kernel_args.get(device)
        if args is None:
            k0, tensors = _head_weights(self, device)
            ci = int(self._chains["prepool"][0]["kernel"].shape[2])
            args = (k0, ci, tuple(t.data_ptr() for t in tensors))
            self._kernel_args[device] = args
        return args


def fold_msfcn_params(msfcn: MultiScaleFCN) -> FoldedHead:
    """Fold a MultiScaleFCN into per-layer (kernel, a, b) with
    ``a = scale / sqrt(var + eps)`` and ``b = bias - mean * a``.
    prepool_i / skip_i / postpool_i are conv -> BN -> relu; trunk_i is
    conv -> relu then trunk_bn_i -> relu, kept as ``pre_relu``. The layers
    the kernel runs on tensor cores also get ``packed``, their weights split
    for 3xTF32 in the kernel's fragment layout (``pack_tf32_fragments``),
    on the module's device. Returns them as a read-only ``FoldedHead``."""

    def stack(name, n):
        for i in range(n):
            if getattr(msfcn, f"{name}_{i}").norm != "BatchNorm_0":
                raise ValueError(
                    f"{name}_{i}: only a BatchNorm folds into the fused "
                    "head (the JAX package's fold_msfcn_params reads "
                    "BatchNorm_0 alike, reward_pallas.py:53)")
        return [_fold(getattr(msfcn, f"{name}_{i}").Conv_0,
                      getattr(msfcn, f"{name}_{i}").BatchNorm_0, False,
                      name in _TENSOR_CORE_CHAINS)
                for i in range(n)]

    if not msfcn.trunk_bn:
        raise NotImplementedError("MultiScaleFCN trunk without BN")
    return FoldedHead({
        "prepool": stack("prepool", msfcn.n_prepool),
        "skip": stack("skip", msfcn.n_skip),
        "trunk": [_fold(getattr(msfcn, f"trunk_{i}").Conv_0,
                        getattr(msfcn, f"trunk_bn_{i}"), True, True)
                  for i in range(msfcn.n_trunk)],
        "postpool": stack("postpool", msfcn.n_postpool),
    })


def head_tensors(folded: Mapping[str, list[Layer]]) -> list[torch.Tensor]:
    """The tensors of a head with the layers of ``HEAD``, in the order
    ``creste::msfcn_head`` takes them: each layer's HWIO kernel, a and b, in
    ``HEAD``'s order (prepool, skip, trunk, postpool), then the packed
    weights of the six tensor-core layers."""
    layers = [ly for chain in HEAD for ly in folded[chain]]
    if len(layers) != sum(len(v) for v in HEAD.values()):
        raise ValueError(f"the head has {len(layers)} layers; the operator "
                         f"takes {sum(len(v) for v in HEAD.values())}")
    return ([t for ly in layers for t in (ly["kernel"], ly["a"], ly["b"])]
            + [ly["packed"] for ly in layers[:6]])


def head_from_tensors(tensors: list[torch.Tensor]) -> FoldedHead:
    """The ``FoldedHead`` that ``head_tensors`` flattened (the same
    tensors, not copies)."""
    n = sum(len(v) for v in HEAD.values())
    if len(tensors) != 3 * n + 6:
        raise ValueError(f"the operator takes {3 * n + 6} tensors, got "
                         f"{len(tensors)}")
    chains, i = {}, 0
    for chain, want in HEAD.items():
        chains[chain] = []
        for (_, _, _, pre) in want:
            ly = {"kernel": tensors[3 * i], "a": tensors[3 * i + 1],
                  "b": tensors[3 * i + 2], "pre_relu": pre,
                  "post_relu": True}
            if i < 6:
                ly["packed"] = tensors[3 * n + i]
            chains[chain].append(ly)
            i += 1
    return FoldedHead(chains)


def conv_affine_plain(x: torch.Tensor, layer: Layer) -> torch.Tensor:
    """Plain PyTorch version of one folded layer: NHWC in, NHWC out."""
    kh, kw = layer["kernel"].shape[:2]
    y = F.conv2d(x.permute(0, 3, 1, 2), layer["kernel"].permute(3, 2, 0, 1),
                 padding=(kh // 2, kw // 2))
    if layer["pre_relu"]:
        y = F.relu(y)
    y = y * layer["a"][:, None, None] + layer["b"][:, None, None]
    if layer["post_relu"]:
        y = F.relu(y)
    return y.permute(0, 2, 3, 1)


def msfcn_chain(folded: Mapping[str, list[Layer]], x: torch.Tensor,
                conv: Callable[[torch.Tensor, Layer], torch.Tensor]
                ) -> torch.Tensor:
    """The folded head with ``conv`` computing each layer (NHWC)."""
    x = x.float().contiguous()
    H, W = x.shape[1:3]

    def run(layers, t):
        for ly in layers:
            t = conv(t.contiguous(), ly)
        return t

    # K1: prepool, forking the skip branch off its output
    p_out = run(folded["prepool"], x)
    s_out = run(folded["skip"], p_out)
    # 2x2 maxpool, then K2: the trunk at half resolution
    t = F.max_pool2d(p_out.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
    t = run(folded["trunk"], t)
    # bilinear x2 upsample + concat, then K3: the postpool
    t = resize_bilinear(t.permute(0, 3, 1, 2), (H, W)).permute(0, 2, 3, 1)
    return run(folded["postpool"], torch.cat([t, s_out], dim=-1))


def msfcn_plain(folded: Mapping[str, list[Layer]],
                x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the whole folded head, on any device;
    the reference the kernel is held against."""
    return msfcn_chain(folded, x, conv_affine_plain)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("msfcn_chain")
    i = ctypes.c_int
    lib.msfcn_head.argtypes = [ctypes.c_void_p, i, i, i, i, i,
                               ctypes.POINTER(i), ctypes.c_void_p]
    lib.msfcn_head.restype = ctypes.c_int
    lib.msfcn_error_string.argtypes = [ctypes.c_int]
    lib.msfcn_error_string.restype = ctypes.c_char_p
    return lib


def _head_weights(folded: Mapping[str, list[Layer]],
                  device: torch.device) -> tuple[int, list[torch.Tensor]]:
    """Checks that ``folded`` is the head the kernel runs, with every tensor
    on ``device``; returns k0 and the tensors in the kernel's order: the six
    packed weights, the final 1x1's weights, a[7], b[7]."""
    layers = []
    for chain, want in HEAD.items():
        got = folded.get(chain, [])
        if len(got) != len(want):
            raise ValueError(f"{chain} has {len(got)} layers; the kernel "
                             f"runs {len(want)}")
        layers += list(zip(got, want))
    k0 = int(layers[0][0]["kernel"].shape[0])
    for i, (ly, (k, ci, co, pre)) in enumerate(layers):
        kh, kw, lci, lco = ly["kernel"].shape
        if i == 0:
            k, ci = k0, lci
        if (kh, kw, lci, lco) != (k, k, ci, co) or ly["pre_relu"] != pre \
                or not ly["post_relu"]:
            raise ValueError(f"layer {i} is {kh}x{kw} {lci}->{lco} "
                             f"pre_relu={ly['pre_relu']}; the kernel runs "
                             f"{k}x{k} {ci}->{co} pre_relu={pre}")
        if i < 6 and "packed" not in ly:
            raise ValueError(f"layer {i} has no packed weights: fold it "
                             "with fold_msfcn_params")
    if k0 % 2 == 0 or k0 > 5:
        raise ValueError(f"the first layer must be odd and <= 5, got {k0}")
    tensors = ([ly["packed"] for ly, _ in layers[:6]]
               + [layers[6][0]["kernel"]]
               + [ly["a"] for ly, _ in layers] + [ly["b"] for ly, _ in layers])
    for t in tensors:
        if t.device != device or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"the folded head's tensors must be contiguous "
                             f"float32 on {device}, got {t.dtype} on "
                             f"{t.device}")
    return k0, tensors


def msfcn_head_cuda(folded: FoldedHead, x: torch.Tensor) -> torch.Tensor:
    """The folded head as the four launches of ``csrc/msfcn_chain.cu``:
    x [B, H, W, Ci] -> [B, H, W, 1], NHWC.

    Takes a contiguous f32 CUDA tensor with Ci a multiple of 8 up to 64 and
    H, W >= 2, and the head of ``HEAD`` folded by ``fold_msfcn_params`` on
    x's device; raises on anything else and on a launch error. Adds one to
    ``msfcn_head_cuda.launches`` for each kernel it launched (four per
    head)."""
    if not isinstance(folded, FoldedHead):
        raise TypeError("the head must be folded by fold_msfcn_params, got "
                        f"{type(folded).__name__}")
    if x.device.type != "cuda":
        raise ValueError(f"x must be a CUDA tensor, got {x.device}")
    if x.dtype != torch.float32:
        raise ValueError(f"x must be float32, got {x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be contiguous and 16-byte aligned")
    if x.dim() != 4:
        raise ValueError(f"x must be [B,H,W,C], got {tuple(x.shape)}")
    B, H, W, Ci = x.shape
    if Ci % 8 or not 8 <= Ci <= 64 or H < 2 or W < 2 or not 1 <= B <= 32767:
        raise ValueError(f"unsupported input {tuple(x.shape)}: Ci a multiple "
                         "of 8 up to 64, H and W >= 2, 1 <= B <= 32767")
    if B * H * W * 64 >= 2**31:
        raise ValueError(f"tensor too large for the kernel: {tuple(x.shape)}")
    k0, ci, wptrs = folded.kernel_args(x.device)
    if ci != Ci:
        raise ValueError(f"x has {Ci} channels, the head takes {ci}")
    # one workspace: p0 [B,H,W,64], s_out [B,H,W,16], pooled and t
    # [B,H/2,W/2,32]; every size a multiple of 4 floats (16 bytes)
    n, m = B * H * W, B * (H // 2) * (W // 2)
    work = torch.empty(80 * n + 64 * m, dtype=torch.float32, device=x.device)
    out = torch.empty((B, H, W, 1), dtype=torch.float32, device=x.device)
    base = work.data_ptr()
    ptrs = (ctypes.c_uint64 * 27)(
        x.data_ptr(), *wptrs, base,
        base + 4 * 64 * n, base + 4 * 80 * n, base + 4 * (80 * n + 32 * m),
        out.data_ptr())
    launched = ctypes.c_int(0)
    lib = _lib()
    err = lib.msfcn_head(ptrs, B, H, W, Ci, k0, ctypes.byref(launched),
                         torch.cuda.current_stream(x.device).cuda_stream)
    msfcn_head_cuda.launches += launched.value
    if err:
        raise RuntimeError(f"msfcn_head launch failed: "
                           f"{lib.msfcn_error_string(err).decode()}")
    return out


msfcn_head_cuda.launches = 0


@torch.library.custom_op("creste::msfcn_head", mutates_args=(),
                         device_types="cpu")
def msfcn_head_op(x: torch.Tensor, weights: list[torch.Tensor]
                  ) -> torch.Tensor:
    """``creste::msfcn_head``: the folded head (``head_tensors``) on x
    [B, H, W, Ci] f32 -> [B, H, W, 1] f32, NHWC. On the CPU the plain
    version."""
    return msfcn_plain(head_from_tensors(list(weights)), x)


@msfcn_head_op.register_kernel("cuda")
def _msfcn_head_cuda_op(x: torch.Tensor, weights: list[torch.Tensor]
                        ) -> torch.Tensor:
    return msfcn_head_cuda(head_from_tensors(list(weights)), x)


@msfcn_head_op.register_fake
def _msfcn_head_fake(x: torch.Tensor, weights: list[torch.Tensor]
                     ) -> torch.Tensor:
    return x.new_empty((*x.shape[:3], 1), dtype=torch.float32)


def msfcn_fused_apply(folded: FoldedHead, x: torch.Tensor) -> torch.Tensor:
    """Folded inference MultiScaleFCN: x [B, H, W, C] -> [B, H, W, 1] NHWC,
    read in f32. ``folded`` comes from ``fold_msfcn_params``. One call of
    the operator ``creste::msfcn_head``, as the deployment graph makes it:
    CUDA tensors go through the kernel, CPU tensors through the plain
    version, any other device raises."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"x must be a CPU or CUDA tensor, got {x.device}")
    return torch.ops.creste.msfcn_head(x.float().contiguous(),
                                       head_tensors(folded))
