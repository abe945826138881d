"""The CODa reader's frame assembly on the card: nvJPEG's decode and the
hand-written kernel ``assemble_rgbd`` (``csrc/frame_io.cu``).

No TPU kernel stands behind it: it is the card's counterpart of the JAX
package's native decode core (``native/creste_io.cpp``, libjpeg's decode
and the fused RGBD assembly), fused with the reader's PIL resize. nvJPEG
decodes a JPEG into its Y, Cb and Cr planes (the chroma at the file's
subsampling); from those and the uint16 depth map (mm) [H, W] the kernel
writes the sample's RGBD [h, w, 4] f32: the RGB PIL decodes, / 255, after
Pillow's BILINEAR resize, and the depth after Pillow's NEAREST resize.

From the planes to RGB the arithmetic is libjpeg-turbo's, which PIL runs:
its "fancy" (triangle) chroma upsampling (``jdsample.c``) and its
fixed-point YCbCr -> RGB (``jdcolor.c``), in ``ycc_to_rgb_plain``. So
the card's RGB differs from PIL's only where nvJPEG's inverse DCT rounds
otherwise than libjpeg's. The resize is Pillow's (``Resample.c``, 8 bits
per channel): integer weights of 22 fractional bits computed in doubles
on the host (``bilinear_coeffs``), a horizontal pass into uint8, then a
vertical one; NEAREST takes the rows and columns Pillow's scaling loop
accumulates (``nearest_index``). ``assemble_rgbd_plain`` is the resize in
torch integer ops on the CPU: the tests hold it and ``ycc_to_rgb_plain``
against PIL, and the card's kernel is held against the two.

The kernel is tiled: ``tile_plan`` cuts the output into tiles, computes
each tile row's and column's input extent (Pillow's windows are
monotone) and the shared-memory layout, once per resize, and refuses a
resize whose single output's window does not fit a block.
"""
from __future__ import annotations

import ctypes
import functools
import math
import threading

import numpy as np
import torch

from creste_public_tpu_torch.ops import _build

PRECISION_BITS = 22  # Pillow's 32 - 8 - 2
_HALF = 1 << (PRECISION_BITS - 1)


def bilinear_coeffs(in_size: int, out_size: int
                    ) -> tuple[np.ndarray, np.ndarray]:
    """Pillow's BILINEAR weights for one axis: (bounds int32 [out, 2], the
    first input and the count of each output's window; weights int32
    [out, K], 22 fractional bits, 0 past the count). ``precompute_coeffs``
    and ``normalize_coeffs_8bpc`` in doubles, step for step."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale  # the triangle filter's support is 1
    ksize = int(math.ceil(support)) * 2 + 1
    bounds = np.zeros((out_size, 2), np.int32)
    weights = np.zeros((out_size, ksize), np.int32)
    ss = 1.0 / filterscale
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = []
        for x in range(xmax):
            t = abs((x + xmin - center + 0.5) * ss)
            k.append(1.0 - t if t < 1.0 else 0.0)
        ww = sum(k) if k else 0.0
        for x, kv in enumerate(k):
            kv = kv / ww if ww != 0.0 else kv
            weights[xx, x] = int((-0.5 if kv < 0 else 0.5)
                                 + kv * (1 << PRECISION_BITS))
        bounds[xx] = (xmin, xmax)
    return bounds, weights


def nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """int32 [out]: the input index Pillow's NEAREST resize reads for each
    output, as its scaling loop accumulates it (``xo = a / 2``, then ``xo
    += a``); not ``floor((x + 0.5) * a)``, which differs at some sizes."""
    a = in_size / out_size
    xo, out = a * 0.5, np.empty(out_size, np.int32)
    for x in range(out_size):
        out[x] = int(xo)
        xo += a
    return out


@functools.lru_cache(maxsize=16)
def frame_tables(H: int, W: int, h: int, w: int) -> dict[str, np.ndarray]:
    """The host tables of one resize [H, W] -> [h, w]."""
    hb, hk = bilinear_coeffs(W, w)
    vb, vk = bilinear_coeffs(H, h)
    return {"hbounds": hb, "hweights": hk, "vbounds": vb, "vweights": vk,
            "rows": nearest_index(H, h), "cols": nearest_index(W, w)}


# The tiled kernel (csrc/frame_io.cu): a block of TILE_THREADS threads
# owns a tile of th x tw outputs, with every input its windows read staged
# in shared memory. TILE_SHAPES are tried in order, the first whose
# largest tile fits SMEM_BUDGET (the H100's opt-in shared memory per
# block, 227 KB) taken: a strong downscale widens the windows and takes a
# smaller tile, down to one output. tw is a power of two that divides
# TILE_THREADS, and th * tw <= TILE_THREADS * OUT_PER_THREAD (the outputs,
# and their depth values prefetched into registers, per thread).
TILE_THREADS = 512
OUT_PER_THREAD = 4
SMEM_BUDGET = 232448
TILE_SHAPES = ((20, 64), (16, 64), (16, 32), (8, 32), (8, 16), (4, 16),
               (4, 8), (2, 8), (2, 4), (1, 4), (1, 2), (1, 1))
# the int32 layout handed to frame_assemble_rgbd, in this order: the tile
# (th, tw), the staged rows' pitches (luma and chroma bytes, RGB words),
# the byte offsets in shared memory of each part (the luma rows at 0), and
# the bytes in all
PLAN_FIELDS = ("th", "tw", "luma_pitch", "chroma_pitch", "rgb_pitch", "cb",
               "cr", "rgb", "hbuf", "hk", "hb", "vk", "vb", "nearest", "lut",
               "bytes")


def axis_extents(bounds: np.ndarray, t: int, n_in: int, s: int
                 ) -> np.ndarray:
    """int32 [tiles, 4] for one axis cut into tiles of ``t`` outputs: each
    tile's luma extent [lo, hi), from its first output's window start to
    its last one's end, and the chroma extent [clo, chi) that libjpeg's
    fancy upsampling reads for those luma samples (subsampling ``s``: the
    one-sample halo each side, clamped at the plane's edges as it clamps).
    Raises unless the windows are monotone, on which the extents rest."""
    start = bounds[:, 0].astype(np.int64)
    end = start + bounds[:, 1]
    if (np.diff(start) < 0).any() or (np.diff(end) < 0).any():
        raise ValueError("the resize's windows are not monotone: no tile "
                         "extent covers them")
    first = np.arange(0, len(bounds), t)
    last = np.minimum(first + t, len(bounds)) - 1
    lo, hi = start[first], end[last]
    if s == 1:
        clo, chi = lo, hi
    else:
        n_c = -(-n_in // s)
        clo = np.maximum(lo // s - 1, 0)
        chi = np.minimum((hi - 1) // s + 2, n_c)
    return np.stack([lo, hi, clo, chi], axis=1).astype(np.int32)


def _staged_pitch(n: int) -> int:
    """Bytes of a staged plane row of ``n`` bytes: 16-byte chunks from the
    aligned address at or below its first byte (up to 15 bytes ahead)."""
    return 16 * (-(-(n + 15) // 16))


def _layout(th: int, tw: int, rows: np.ndarray, cols: np.ndarray, kh: int,
            kv: int) -> dict[str, int]:
    R = int((rows[:, 1] - rows[:, 0]).max())
    Rc = int((rows[:, 3] - rows[:, 2]).max())
    C = int((cols[:, 1] - cols[:, 0]).max())
    Cc = int((cols[:, 3] - cols[:, 2]).max())
    out = {"th": th, "tw": tw, "luma_pitch": _staged_pitch(C),
           "chroma_pitch": _staged_pitch(Cc), "rgb_pitch": C}
    parts = (("luma", R * out["luma_pitch"]),  # the staged planes
             ("cb", Rc * out["chroma_pitch"]),
             ("cr", Rc * out["chroma_pitch"]),
             ("rgb", 4 * R * C),  # packed RGB per input pixel
             ("hbuf", 4 * R * tw),  # the horizontal pass per input row
             ("hk", 4 * kh * tw),  # column weights [kh, tw]
             ("hb", 8 * tw),  # column (start, count)
             ("vk", 4 * kv * th),  # row weights [kv, th]
             ("vb", 8 * th),  # row (start, count)
             ("nearest", 4 * (th + tw)),  # NEAREST's rows, then columns
             ("lut", 4 * 256))  # v / 255 for v in 0..255
    at = 0
    for name, size in parts:  # each part 16-byte aligned, in this order
        out[name] = at
        at += -(-size // 16) * 16
    out["bytes"] = at
    return out


@functools.lru_cache(maxsize=16)
def tile_plan(H: int, W: int, h: int, w: int, sh: int, sv: int) -> dict:
    """The launch plan of one resize [H, W] -> [h, w] at chroma subsampling
    (sh, sv): the tile, each tile row's and column's extents
    (``axis_extents``: "rows" [ceil(h / th), 4], "cols" [ceil(w / tw),
    4]) and the shared-memory layout ("layout", int32 in ``PLAN_FIELDS``
    order; "bytes"). Raises ValueError, naming the sizes and the limit,
    when even one output's window does not fit ``SMEM_BUDGET``."""
    t = frame_tables(H, W, h, w)
    kh, kv = t["hweights"].shape[1], t["vweights"].shape[1]
    for th, tw in TILE_SHAPES:
        rows = axis_extents(t["vbounds"], th, H, sv)
        cols = axis_extents(t["hbounds"], tw, W, sh)
        lay = _layout(th, tw, rows, cols, kh, kv)
        if lay["bytes"] <= SMEM_BUDGET:
            return {"rows": rows, "cols": cols, "bytes": lay["bytes"],
                    "layout": np.array([lay[k] for k in PLAN_FIELDS],
                                       np.int32)}
    raise ValueError(
        f"assemble_rgbd cannot resize [{H},{W}] to [{h},{w}]: one output's "
        f"window takes {lay['bytes']} bytes of shared memory, over the "
        f"{SMEM_BUDGET} bytes a block may use")


@functools.lru_cache(maxsize=16)
def device_tables(H: int, W: int, h: int, w: int, sh: int, sv: int,
                  device: torch.device) -> dict[str, torch.Tensor]:
    """``frame_tables`` and ``tile_plan``'s extents ("tile_rows",
    "tile_cols") on ``device``, made once per (sizes, device)."""
    plan = tile_plan(H, W, h, w, sh, sv)
    tables = dict(frame_tables(H, W, h, w), tile_rows=plan["rows"],
                  tile_cols=plan["cols"])
    return {k: torch.from_numpy(v).to(device) for k, v in tables.items()}


def out_size(H: int, W: int, size) -> tuple[int, int]:
    """(h, w) of ``size`` ((h, w), or None for [H, W] itself)."""
    h, w = (H, W) if size is None else (int(size[0]), int(size[1]))
    if h < 1 or w < 1:
        raise ValueError(f"output size must be positive, got {size}")
    return h, w


def _resample(x: torch.Tensor, bounds: np.ndarray,
              weights: np.ndarray) -> torch.Tensor:
    """One of Pillow's 8-bpc passes along axis 1 of a uint8 [A, N, C]."""
    K = weights.shape[1]
    idx = torch.from_numpy(bounds[:, :1] + np.arange(K)).long().clamp_(
        max=x.shape[1] - 1)
    g = x.to(torch.int32)[:, idx.reshape(-1)].reshape(
        x.shape[0], len(bounds), K, x.shape[2])
    acc = (g * torch.from_numpy(weights)[None, :, :, None]).sum(
        2, dtype=torch.int32) + _HALF
    return (acc >> PRECISION_BITS).clamp_(0, 255).to(torch.uint8)


# libjpeg's FIX(x) of its YCbCr -> RGB constants, 16 fractional bits
# (jdcolor.c): FIX(1.40200), FIX(1.77200), FIX(0.34414), FIX(0.71414)
CR_R, CB_B, CB_G, CR_G = 91881, 116130, 22554, 46802


def subsampling(H: int, W: int, ch: int, cw: int) -> tuple[int, int]:
    """(horizontal, vertical) chroma factors of planes [ch, cw] under a
    luma plane [H, W]: 4:4:4, 4:2:2 or 4:2:0; raises on the others."""
    sh = 1 if cw == W else 2 if cw == -(-W // 2) else 0
    sv = 1 if ch == H else 2 if ch == -(-H // 2) else 0
    if (sh, sv) not in ((1, 1), (2, 1), (2, 2)):
        raise ValueError(f"chroma planes [{ch},{cw}] under luma [{H},{W}]: "
                         "only 4:4:4, 4:2:2 and 4:2:0 are taken")
    return sh, sv


def _upsample(c: torch.Tensor, H: int, W: int, sh: int,
              sv: int) -> torch.Tensor:
    """int32 [H, W]: libjpeg-turbo's fancy upsampling of a chroma plane
    (h2v2 and h2v1 ``fancy_upsample``: 3/4 of the nearer sample and 1/4 of
    the further one per axis, edges repeated, the rounding bias alternating
    by column)."""
    ch, cw = c.shape
    c = c.to(torch.int32)
    r, x = torch.arange(H), torch.arange(W)
    cy = r // sv
    cx = x // sh
    if sh == 1:
        return c[cy][:, cx]
    nx = torch.where(x % 2 == 1, (cx + 1).clamp(max=cw - 1),
                     (cx - 1).clamp(min=0))
    odd = (x % 2 == 1).to(torch.int32)
    if sv == 1:
        return (3 * c[cy][:, cx] + c[cy][:, nx] + 1 + odd) >> 2
    ny = torch.where(r % 2 == 1, (cy + 1).clamp(max=ch - 1),
                     (cy - 1).clamp(min=0))
    near = 3 * c[cy] + c[ny]  # the column sums of the two rows [H, cw]
    return (3 * near[:, cx] + near[:, nx] + 8 - odd) >> 4


def ycc_to_rgb_plain(y: torch.Tensor, cb: torch.Tensor,
                     cr: torch.Tensor) -> torch.Tensor:
    """uint8 [H, W, 3] RGB from a JPEG's decoded planes (uint8 luma [H, W],
    chroma at 4:4:4, 4:2:2 or 4:2:0), as libjpeg-turbo computes it: fancy
    upsampling, then ``ycc_rgb_convert``'s fixed point."""
    y, cb, cr = y.cpu(), cb.cpu(), cr.cpu()
    H, W = y.shape
    sh, sv = subsampling(H, W, *cb.shape)
    b = _upsample(cb, H, W, sh, sv) - 128
    r = _upsample(cr, H, W, sh, sv) - 128
    y = y.to(torch.int32)
    half = 1 << 15
    return torch.stack([y + ((CR_R * r + half) >> 16),
                        y + ((half - CB_G * b - CR_G * r) >> 16),
                        y + ((CB_B * b + half) >> 16)],
                       dim=-1).clamp_(0, 255).to(torch.uint8)


def assemble_rgbd_plain(rgb: torch.Tensor, depth: torch.Tensor | None,
                        size=None) -> torch.Tensor:
    """[h, w, 4] f32 from rgb uint8 [H, W, 3] and depth uint16 [H, W] (or
    None: a zero depth channel), resized to ``size`` (h, w) (None: kept):
    the kernel's function in torch integer ops, on the CPU."""
    H, W = rgb.shape[:2]
    h, w = out_size(H, W, size)
    t = frame_tables(H, W, h, w)
    x = _resample(rgb.cpu(), t["hbounds"], t["hweights"])
    x = _resample(x.transpose(0, 1), t["vbounds"], t["vweights"])
    out = torch.empty((h, w, 4), dtype=torch.float32)
    out[..., :3] = x.transpose(0, 1).to(torch.float32) / 255.0
    if depth is None:
        out[..., 3] = 0.0
    else:
        rows = torch.from_numpy(t["rows"]).long()
        cols = torch.from_numpy(t["cols"]).long()
        out[..., 3] = depth.cpu()[rows][:, cols].to(torch.float32)
    return out


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("frame_io")
    p, i, n = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
    for name, args in (
            ("frame_decoder_create", [i, ctypes.POINTER(p)]),
            ("frame_decoder_destroy", [p]),
            ("frame_jpeg_info", [i, p, n, ctypes.POINTER(i)]),
            ("frame_jpeg_decode", [p, p, n, p, p, p, i, i, p]),
            ("frame_assemble_rgbd", [p, p, p, i, i, i, i, i, i, p, p, p, i,
                                     p, p, i, p, p, p, p, p, p, i, i, p])):
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = i
    lib.frame_backend_name.argtypes = []
    lib.frame_backend_name.restype = ctypes.c_char_p
    lib.frame_error_string.argtypes = [i]
    lib.frame_error_string.restype = ctypes.c_char_p
    return lib


def _check(err: int, what: str) -> None:
    if err:
        raise RuntimeError(
            f"{what} failed: {_lib().frame_error_string(err).decode()}")


def nvjpeg_backend() -> str:
    """The nvJPEG backend the library was built with (one constant)."""
    return _lib().frame_backend_name().decode()


def cuda_device(device: str | torch.device) -> torch.device:
    """``device`` with its card's index (the current one when unset);
    raises for any other device type."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"nvJPEG decodes on a CUDA device, not {device}")
    return torch.device("cuda", torch.cuda.current_device()
                        if device.index is None else device.index)


def _jpeg_bytes(data: np.ndarray) -> np.ndarray:
    if not (isinstance(data, np.ndarray) and data.dtype == np.uint8
            and data.ndim == 1 and data.flags.c_contiguous):
        raise ValueError("a JPEG's bytes must be a contiguous uint8 numpy "
                         "array")
    return data


def jpeg_info(data: np.ndarray, device: torch.device
              ) -> tuple[int, int, int, int, int]:
    """(height, width, components, the chroma planes' height and width) of
    a JPEG's bytes, read by nvJPEG's parser."""
    data, device = _jpeg_bytes(data), cuda_device(device)
    info = (ctypes.c_int * 5)()
    _check(_lib().frame_jpeg_info(device.index, data.ctypes.data, data.nbytes,
                                  info), "nvjpegGetImageInfo")
    return tuple(info)


class JpegDecoder:
    """One nvJPEG state on a card: decodes one JPEG at a time, so a thread
    that decodes holds one (``DeviceFrameDecoder`` pools them). Raises
    when the backend or the state cannot be made."""

    def __init__(self, device: torch.device):
        self.device = cuda_device(device)
        ptr = ctypes.c_void_p()
        _check(_lib().frame_decoder_create(self.device.index,
                                           ctypes.byref(ptr)),
               f"nvJPEG ({nvjpeg_backend()}) decoder creation")
        self._ptr = ptr

    def decode(self, data: np.ndarray
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The Y [H, W], Cb and Cr [ch, cw] uint8 planes on the card of a
        JPEG's bytes, decoded on the current stream."""
        data = _jpeg_bytes(data)
        H, W, comps, ch, cw = jpeg_info(data, self.device)
        if comps != 3:
            raise ValueError(f"the card's decode takes 3-component JPEGs, "
                             f"got {comps}")
        subsampling(H, W, ch, cw)
        y = torch.empty((H, W), dtype=torch.uint8, device=self.device)
        # each chroma plane in a luma-sized buffer: nvJPEG writes [ch, cw]
        # at pitch cw
        cb, cr = (torch.empty(H * W, dtype=torch.uint8, device=self.device)
                  [:ch * cw].view(ch, cw) for _ in range(2))
        stream = torch.cuda.current_stream(self.device).cuda_stream
        _check(_lib().frame_jpeg_decode(
            self._ptr, data.ctypes.data, data.nbytes, y.data_ptr(),
            cb.data_ptr(), cr.data_ptr(), W, cw, stream), "nvJPEG decode")
        return y, cb, cr

    def close(self) -> None:
        if self._ptr is not None:
            _check(_lib().frame_decoder_destroy(self._ptr),
                   "nvjpegJpegStateDestroy")
            self._ptr = None


_LAUNCH_LOCK = threading.Lock()


@torch.no_grad()
def assemble_rgbd_cuda(planes, depth: torch.Tensor | None,
                       size=None) -> torch.Tensor:
    """[h, w, 4] f32 from a JPEG's decoded planes (y, cb, cr) (uint8 luma
    [H, W], chroma at 4:4:4, 4:2:2 or 4:2:0) and depth uint16 [H, W] (or
    None), all contiguous on one CUDA device, in one launch on the current
    stream: ``assemble_rgbd_plain(ycc_to_rgb_plain(*planes), depth,
    size)`` to the bit, tiled as ``tile_plan`` plans it. Raises on
    anything else, on a resize whose single output's window does not fit
    a block's shared memory (before any launch), and on a launch error.
    Adds one to ``assemble_rgbd_cuda.launches`` per launch (loader threads
    call it concurrently)."""
    y, cb, cr = planes
    if any(p.dtype != torch.uint8 or p.dim() != 2 for p in planes) or \
            cb.shape != cr.shape:
        raise ValueError("planes must be uint8 [H,W], [ch,cw], [ch,cw], got "
                         + ", ".join(f"{p.dtype} {tuple(p.shape)}"
                                     for p in planes))
    H, W = y.shape
    sh, sv = subsampling(H, W, *cb.shape)
    if depth is not None and (depth.dtype != torch.uint16
                              or tuple(depth.shape) != (H, W)):
        raise ValueError(f"depth must be uint16 [{H},{W}], got "
                         f"{depth.dtype} {tuple(depth.shape)}")
    h, w = out_size(H, W, size)
    plan = tile_plan(H, W, h, w, sh, sv)
    if y.device.type != "cuda":
        raise ValueError(f"the planes must be CUDA tensors, got {y.device}")
    inputs = list(planes) + ([] if depth is None else [depth])
    if any(t.device != y.device for t in inputs):
        raise ValueError(f"planes and depth must lie on one device, got "
                         f"{[str(t.device) for t in inputs]}")
    if not all(t.is_contiguous() for t in inputs):
        raise ValueError("planes and depth must be contiguous")
    t = device_tables(H, W, h, w, sh, sv, y.device)
    out = torch.empty((h, w, 4), dtype=torch.float32, device=y.device)
    stream = torch.cuda.current_stream(y.device).cuda_stream
    _check(_lib().frame_assemble_rgbd(
        y.data_ptr(), cb.data_ptr(), cr.data_ptr(), H, W, cb.shape[0],
        cb.shape[1], sh, sv, None if depth is None else depth.data_ptr(),
        t["hbounds"].data_ptr(), t["hweights"].data_ptr(),
        t["hweights"].shape[1], t["vbounds"].data_ptr(),
        t["vweights"].data_ptr(), t["vweights"].shape[1],
        t["rows"].data_ptr(), t["cols"].data_ptr(),
        t["tile_rows"].data_ptr(), t["tile_cols"].data_ptr(),
        plan["layout"].ctypes.data, out.data_ptr(), h, w, stream),
        "assemble_rgbd launch")
    with _LAUNCH_LOCK:
        assemble_rgbd_cuda.launches += 1
    return out


assemble_rgbd_cuda.launches = 0


# integer operations per input pixel to RGB: each chroma plane's h2v2
# upsampling (two column sums, the blend: ~8) and the conversion (three
# channels' products, shifts, adds and clamps: ~20)
_YCC_OPS = 36


def frame_bound(H: int, W: int, h: int, w: int, depth: bool,
                sh: int = 2, sv: int = 2) -> dict[str, float]:
    """What ``assemble_rgbd`` must move for one frame: the luma and chroma
    planes read once, the depth rows NEAREST reads (distinct rows, full
    width), the output written once; and its integer operations (every
    input pixel to RGB once, the horizontal pass once per input row of
    each output's window and column, the vertical pass once, as
    multiply-adds)."""
    t = frame_tables(H, W, h, w)
    rows = len(np.unique(t["rows"])) if depth else 0
    nx = t["hbounds"][:, 1].astype(np.int64)
    ny = t["vbounds"][:, 1].astype(np.int64)
    macs = 3 * ny.sum() * (nx.sum() + w)
    chroma = 2 * (-(-H // sv)) * (-(-W // sh))
    return {"bytes": H * W + chroma + rows * W * 2 + h * w * 16,
            "ops": 2 * float(macs) + _YCC_OPS * H * W}
