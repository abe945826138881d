"""Expected-SVF propagation on a hand-written CUDA kernel (``csrc/svf.cu``).

Counterpart of ``creste_public_tpu/ops/svf_pallas.py``: all T-1 steps of
the horizon in one launch, one thread block per batch element, with the
visitation maps in shared memory. ``ops/svf.py`` holds the plain version
this kernel is checked against. Forward only, like the JAX kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from creste_public_tpu_torch.ops import _build

# a block's shared memory on an H100 (227 KB) over the kernel's three maps
MAX_CELLS = 232448 // (3 * 4)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("svf")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.svf_propagate.argtypes = [p, p, p, p, i, i, i, i, i, p]
    lib.svf_propagate.restype = ctypes.c_int
    lib.svf_error_string.argtypes = [ctypes.c_int]
    lib.svf_error_string.restype = ctypes.c_char_p
    return lib


@torch.no_grad()
def expected_svf_cuda(policy: torch.Tensor, s0: torch.Tensor,
                      s1: torch.Tensor, horizon: int,
                      zero_terminal_state: bool = False) -> torch.Tensor:
    """mu [B, H, W] from policy [B, H, W, 8] and s0/s1 [B] in one launch.

    Takes a contiguous f32 CUDA policy and integer s0/s1 on its device;
    raises on anything else and on a launch error. Adds one to
    ``expected_svf_cuda.launches`` for each launch."""
    if policy.device.type != "cuda":
        raise ValueError(f"policy must be a CUDA tensor, got {policy.device}")
    if policy.dtype != torch.float32:
        raise ValueError(f"policy must be float32, got {policy.dtype}")
    if not policy.is_contiguous():
        raise ValueError("policy must be contiguous")
    if policy.dim() != 4 or policy.shape[-1] != 8:
        raise ValueError(f"policy must be [B,H,W,8], got {tuple(policy.shape)}")
    B, H, W, _ = policy.shape
    for name, s in (("s0", s0), ("s1", s1)):
        if s.device != policy.device:
            raise ValueError(f"{name} must lie on the policy's device, got "
                             f"{s.device}")
        if s.dtype not in (torch.int32, torch.int64) or s.shape != (B,):
            raise ValueError(f"{name} must be int32/int64 [B], got {s.dtype} "
                             f"{tuple(s.shape)}")
    if H * W > MAX_CELLS or B == 0:
        raise ValueError(f"unsupported map size for the kernel: "
                         f"{tuple(policy.shape)}")
    if horizon < 1:
        raise ValueError(f"horizon must be >= 1, got {horizon}")
    pol = policy.permute(0, 3, 1, 2).contiguous()
    s0i = s0.to(torch.int32).contiguous()
    s1i = s1.to(torch.int32).contiguous()
    out = torch.empty((B, H, W), dtype=torch.float32, device=policy.device)
    lib = _lib()
    stream = torch.cuda.current_stream(policy.device).cuda_stream
    err = lib.svf_propagate(pol.data_ptr(), s0i.data_ptr(), s1i.data_ptr(),
                            out.data_ptr(), B, H, W, horizon,
                            int(zero_terminal_state), stream)
    if err:
        raise RuntimeError(
            f"svf_propagate launch failed: {lib.svf_error_string(err).decode()}")
    expected_svf_cuda.launches += 1
    return out


expected_svf_cuda.launches = 0
