"""Expected-SVF propagation on a hand-written CUDA kernel (``csrc/svf.cu``).

Counterpart of ``creste_public_tpu/ops/svf_pallas.py``: all T-1 steps of
the horizon in one launch, each batch element's map split in bands of rows
over a thread-block cluster whose blocks store their edge rows into each
other's shared memory. ``ops/svf.py`` holds the plain version this kernel
is checked against. Forward only, like the JAX kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from creste_public_tpu_torch.ops import _build

# csrc/svf.cu's kClusterBlocks and kThreads * kCellsPerThread (the tests
# read them from the source): blocks per cluster at most, and the cells of
# one band at most (its policy, mu and total stay in registers)
CLUSTER_BLOCKS = 8
MAX_BAND_CELLS = 1024 * 2


def cluster_shape(H: int) -> tuple[int, int]:
    """(blocks per cluster C, rows per band R) that csrc/svf.cu launches for
    a map of H rows: the fewest rows that split H over at most
    ``CLUSTER_BLOCKS`` blocks, and the fewest blocks for that band."""
    R = -(-H // CLUSTER_BLOCKS)
    return -(-H // R), R


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("svf")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.svf_propagate.argtypes = [p, p, p, p, i, i, i, i, i, p,
                                  ctypes.POINTER(ctypes.c_int)]
    lib.svf_propagate.restype = ctypes.c_int
    lib.svf_error_string.argtypes = [ctypes.c_int]
    lib.svf_error_string.restype = ctypes.c_char_p
    return lib


@torch.no_grad()
def expected_svf_cuda(policy: torch.Tensor, s0: torch.Tensor,
                      s1: torch.Tensor, horizon: int,
                      zero_terminal_state: bool = False) -> torch.Tensor:
    """mu [B, H, W] from policy [B, H, W, 8] and s0/s1 [B] in one launch.

    Takes a contiguous f32 CUDA policy, read as it is, and integer s0/s1 on
    its device; raises on anything else, on a band of more than
    ``MAX_BAND_CELLS`` cells and on a launch error. Adds one to
    ``expected_svf_cuda.launches`` for each launch, and keeps the launch's
    blocks per cluster, blocks and clusters the card holds at once in
    ``.cluster``, ``.blocks`` and ``.clusters_at_once``."""
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
    if B == 0 or H == 0 or W == 0 or cluster_shape(H)[1] * W > MAX_BAND_CELLS:
        raise ValueError(f"unsupported map size for the kernel: "
                         f"{tuple(policy.shape)} (a band of ceil(H / "
                         f"{CLUSTER_BLOCKS}) rows holds at most "
                         f"{MAX_BAND_CELLS} cells)")
    if horizon < 1:
        raise ValueError(f"horizon must be >= 1, got {horizon}")
    s0i = s0.long().contiguous()
    s1i = s1.long().contiguous()
    out = torch.empty((B, H, W), dtype=torch.float32, device=policy.device)
    lib = _lib()
    stream = torch.cuda.current_stream(policy.device).cuda_stream
    info = (ctypes.c_int * 3)()
    err = lib.svf_propagate(policy.data_ptr(), s0i.data_ptr(), s1i.data_ptr(),
                            out.data_ptr(), B, H, W, horizon,
                            int(zero_terminal_state), stream, info)
    if err:
        raise RuntimeError(
            f"svf_propagate launch failed: {lib.svf_error_string(err).decode()}")
    expected_svf_cuda.launches += 1
    (expected_svf_cuda.cluster, expected_svf_cuda.blocks,
     expected_svf_cuda.clusters_at_once) = info
    return out


expected_svf_cuda.launches = 0
