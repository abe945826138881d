"""The splat's scatter on a hand-written CUDA kernel (``csrc/splat.cu``).

Counterpart of the XLA scatter-adds of ``creste_public_tpu/ops/splat.py``
(:107, :112, :117), which add in a fixed order on the TPU. The kernel sorts
the votes by voxel, keeping their order, and adds each voxel's votes in
that order, rounding every product and sum as the plain version
(``ops/splat.py::splat_sums_plain``) does: it equals the plain version run
on the CPU from the same inputs to the bit, on every run, where the plain
version's CUDA ``index_add_`` adds with atomics.

The operator ``creste::splat_sums(Tensor xy, Tensor feats, int H, int W)
-> Tensor`` is the kernel on CUDA tensors and the plain version on CPU
tensors; its backward is that of the plain version (the votes' gradient
``grad.index_select(0, flat)``, as autograd of ``index_add_`` gives it,
then the vector-Jacobian product of ``ops/splat.py::votes``), which uses no
atomics. ``csrc/splat_op.cpp`` registers the same schema in C++ for the
serving host.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from creste_public_tpu_torch.ops import _build
from creste_public_tpu_torch.ops import splat as splat_ops

# csrc/splat.cu's limits: votes (4 * B * P) and voxels + 1 in int32
MAX_INDEX = 2**31 - 1


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("splat")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.splat_sums.argtypes = [p, p, p, p, i, i, i, i, i, p]
    lib.splat_sums.restype = ctypes.c_int
    lib.splat_sums_workspace.argtypes = [i, i, i, i, i]
    lib.splat_sums_workspace.restype = ctypes.c_longlong
    lib.splat_error_string.argtypes = [ctypes.c_int]
    lib.splat_error_string.restype = ctypes.c_char_p
    lib.splat_row_path.argtypes = [p, i]
    lib.splat_row_path.restype = ctypes.c_int
    return lib


ROW_PATHS = ("no feature rows", "4-byte cp.async", "16-byte cp.async")


def row_path(feats: torch.Tensor) -> str:
    """How ``csrc/splat.cu`` feeds the feature rows of ``feats`` [B, P, F]
    to its crowded voxels' adds (``splat_row_path``): 16-byte ``cp.async``
    of each row's 32-channel slice where F % 4 == 0 and the data is 16-byte
    aligned (the production F = 96), 4-byte ``cp.async`` a channel
    otherwise, no rows at F = 0. Both copy paths fill the same ring and
    give the same bits."""
    return ROW_PATHS[_lib().splat_row_path(feats.data_ptr(),
                                           int(feats.shape[-1]))]


@functools.lru_cache(maxsize=64)
def _workspace(B: int, P: int, H: int, W: int, F: int) -> int:
    """The int32 elements of ``csrc/splat.cu``'s workspace for these sizes
    (a function of the sizes alone)."""
    return _lib().splat_sums_workspace(B, P, H, W, F)


def check_sizes(B: int, P: int, F: int, H: int, W: int) -> None:
    """Raise unless the kernel takes these sizes."""
    if B < 1 or H < 1 or W < 1:
        raise ValueError(f"B, H and W must be >= 1, got B={B}, H={H}, W={W}")
    if 4 * B * P > MAX_INDEX or B * H * W + 1 > MAX_INDEX \
            or B * F > MAX_INDEX:
        raise ValueError(f"too large for the kernel: B={B}, P={P}, F={F}, "
                         f"grid {H}x{W} (4*B*P, B*H*W + 1 and B*F below "
                         "2^31)")


def splat_sums_cuda(xy: torch.Tensor, feats: torch.Tensor,
                    grid_hw: tuple[int, int]) -> torch.Tensor:
    """``splat_sums`` [B, H*W, F+1] f32 from xy [B, P, 2] and feats
    [B, P, F] in one call of ``csrc/splat.cu``'s launch sequence.

    Takes contiguous f32 CUDA tensors on one device; raises on anything
    else and on a launch error. Adds one to ``splat_sums_cuda.launches``
    for each call that launched the kernels (one per splat)."""
    H, W = (int(v) for v in grid_hw)
    for name, t, last in (("xy", xy, 2), ("feats", feats, None)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dim() != 3 or (last is not None and t.shape[-1] != last):
            raise ValueError(f"{name} must be [B,P,{last or 'F'}], got "
                             f"{tuple(t.shape)}")
    if feats.device != xy.device or feats.shape[:2] != xy.shape[:2]:
        raise ValueError(f"feats {tuple(feats.shape)} on {feats.device} "
                         f"does not match xy {tuple(xy.shape)} on "
                         f"{xy.device}")
    B, P, F = feats.shape
    check_sizes(B, P, F, H, W)
    lib = _lib()
    work = torch.empty(_workspace(B, P, H, W, F), dtype=torch.int32,
                       device=xy.device)
    out = torch.empty((B, H * W, F + 1), dtype=torch.float32,
                      device=xy.device)
    stream = torch.cuda.current_stream(xy.device).cuda_stream
    # switching the current device costs host time on every call
    with (contextlib.nullcontext()
          if xy.device.index == torch.cuda.current_device()
          else torch.cuda.device(xy.device)):
        err = lib.splat_sums(xy.data_ptr(), feats.data_ptr(), out.data_ptr(),
                             work.data_ptr(), B, P, F, H, W, stream)
    if err:
        raise RuntimeError(f"splat_sums launch failed: "
                           f"{lib.splat_error_string(err).decode()}")
    splat_sums_cuda.launches += 1
    return out


splat_sums_cuda.launches = 0


@torch.library.custom_op(
    "creste::splat_sums", mutates_args=(), device_types="cpu",
    schema="(Tensor xy, Tensor feats, int H, int W) -> Tensor")
def splat_sums_op(xy: torch.Tensor, feats: torch.Tensor, H: int, W: int
                  ) -> torch.Tensor:
    """``creste::splat_sums``: xy [B, P, 2] f32 and feats [B, P, F] f32 ->
    [B, H*W, F+1] f32. On the CPU the plain version."""
    return splat_ops.splat_sums_plain(xy, feats, (H, W))


@splat_sums_op.register_kernel("cuda")
def _splat_sums_cuda_op(xy: torch.Tensor, feats: torch.Tensor, H: int,
                        W: int) -> torch.Tensor:
    return splat_sums_cuda(xy, feats, (H, W))


@splat_sums_op.register_fake
def _splat_sums_fake(xy: torch.Tensor, feats: torch.Tensor, H: int, W: int
                     ) -> torch.Tensor:
    return feats.new_empty((feats.shape[0], H * W, feats.shape[2] + 1),
                           dtype=torch.float32)


def _setup_context(ctx, inputs, output) -> None:
    xy, feats, H, W = inputs
    ctx.save_for_backward(xy, feats)
    ctx.grid_hw = (H, W)


def _backward(ctx, grad: torch.Tensor):
    """The plain version's backward: ``grad.index_select(0, flat)`` (what
    autograd of ``index_add_`` gives the votes), then autograd of
    ``votes`` from the saved inputs. On the CPU it is autograd of
    ``splat_sums_plain`` op for op, so the two agree to the bit."""
    xy, feats = ctx.saved_tensors
    need = ctx.needs_input_grad[:2]
    with torch.enable_grad():
        leaves = (xy.detach().requires_grad_(need[0]),
                  feats.detach().requires_grad_(need[1]))
        flat, upd = splat_ops.votes(*leaves, ctx.grid_hw)
        g = grad.reshape(-1, upd.shape[-1]).index_select(0, flat)
        wanted = [t for t, n in zip(leaves, need) if n]
        got = iter(torch.autograd.grad(upd, wanted, g.reshape(upd.shape))
                   if wanted else ())
    return (next(got) if need[0] else None,
            next(got) if need[1] else None, None, None)


splat_sums_op.register_autograd(_backward, setup_context=_setup_context)
