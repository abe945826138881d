"""Value iteration on a hand-written CUDA kernel (``csrc/value_iteration.cu``).

Counterpart of ``creste_public_tpu/ops/vi_pallas.py``: the whole solve,
every sweep and the batch-global convergence test, is one cooperative
launch that runs k sweeps per grid barrier on tiles kept in shared memory.
It returns V only; ``ops/value_iteration.py`` computes the policy/Q tail and
holds the plain version this kernel is checked against. Forward only: the
VIN solves on a detached reward.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from creste_public_tpu_torch.ops import _build


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("value_iteration")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.vi_solve.argtypes = [p, p, p, p, p, i, i, i, f, f, i, p]
    lib.vi_solve.restype = ctypes.c_int
    lib.vi_error_string.argtypes = [ctypes.c_int]
    lib.vi_error_string.restype = ctypes.c_char_p
    return lib


@torch.no_grad()
def value_iteration_cuda(r: torch.Tensor, discount: float = 0.99,
                         threshold: float = 1e-3, max_iters: int = 2000
                         ) -> torch.Tensor:
    """V [B, H, W, 1] of the reward r [B, H, W, 1] in one launch.

    Takes a contiguous f32 CUDA tensor; raises on anything else and on a
    launch error. The sweep count and the grid barriers stay on the card as the int32 tensors
    ``value_iteration_cuda.sweeps`` and ``.barriers`` (read them with
    ``.item()``). Adds one to ``value_iteration_cuda.launches`` for each
    launch."""
    if r.device.type != "cuda":
        raise ValueError(f"r must be a CUDA tensor, got {r.device}")
    if r.dtype != torch.float32:
        raise ValueError(f"r must be float32, got {r.dtype}")
    if not r.is_contiguous():
        raise ValueError("r must be contiguous")
    if r.dim() != 4 or r.shape[-1] != 1:
        raise ValueError(f"r must be [B,H,W,1], got {tuple(r.shape)}")
    if max_iters < 0:
        raise ValueError(f"max_iters must be >= 0, got {max_iters}")
    if r.numel() == 0 or 2 * r.numel() >= 2**31:
        raise ValueError(f"r has an unsupported size: {tuple(r.shape)}")
    B, H, W, _ = r.shape
    v = torch.empty_like(r)
    ring = torch.empty(2 * r.numel(), dtype=torch.float32,
                       device=r.device)
    delta_bits = torch.zeros(max(max_iters, 1), dtype=torch.int32,
                             device=r.device)
    info = torch.zeros(2, dtype=torch.int32, device=r.device)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    lib = _lib()
    err = lib.vi_solve(r.data_ptr(), v.data_ptr(), ring.data_ptr(),
                       delta_bits.data_ptr(), info.data_ptr(), B, H, W,
                       discount, threshold, max_iters, stream)
    if err:
        raise RuntimeError(
            f"vi_solve launch failed: {lib.vi_error_string(err).decode()}")
    value_iteration_cuda.launches += 1
    value_iteration_cuda.sweeps = info[:1]
    value_iteration_cuda.barriers = info[1:]
    return v


value_iteration_cuda.launches = 0
value_iteration_cuda.sweeps = None
value_iteration_cuda.barriers = None
