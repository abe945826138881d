"""Per-frame latency and cost of the deployment graph on the card.

Counterpart of ``creste_public_tpu/runtime/benchmark.py``. The JAX
package's scan-difference timing works around a TPU runtime that memoises
repeated executions; on the card a frame is timed directly: CUDA events
around each call, every timed call on a fresh device-resident input (the
RGB channels re-drawn on the device before its events), the median over
repeats. ``cost_stats`` counts the operations of a graph with
``torch.utils.flop_counter`` (convolutions and matrix products; give it the
unfused graph so that the count is the same work whatever runs the reward
head) and the bytes of its parameters, inputs and outputs, a lower bound
on what a frame moves. ``mfu_fields`` reads those against the H100 SXM's
published dense peaks.
"""
from __future__ import annotations

import statistics
from typing import Any, Callable

import torch
from torch.utils.flop_counter import FlopCounterMode

# the H100 SXM's published dense peaks (NVIDIA data sheet, at 700 W)
H100_PEAK_BF16_FLOPS = 989e12  # bf16 on tensor cores
H100_PEAK_TF32_FLOPS = 495e12  # TF32 on tensor cores
H100_PEAK_F32_FLOPS = 67e12  # f32 on CUDA cores
H100_HBM_BYTES_PER_S = 3.35e12  # HBM3


def fresh_frames(rgbd: Any, n: int, device: torch.device,
                 seed: int = 0) -> list[torch.Tensor]:
    """``n`` copies of ``rgbd`` [..., 4] on ``device``, each with its RGB
    channels re-drawn uniform in [0, 1) on the device (depth kept)."""
    base = torch.as_tensor(rgbd, dtype=torch.float32, device=device)
    g = torch.Generator(device=device).manual_seed(seed)
    frames = []
    for _ in range(n):
        x = base.clone()
        x[..., :3] = torch.rand(x[..., :3].shape, generator=g,
                                device=device)
        frames.append(x)
    return frames


def frame_times_ms(fn: Callable, rgbd: Any, p2p: Any, iters: int,
                   device: torch.device, seed: int = 0) -> list[float]:
    """CUDA-event time of each of ``iters`` calls ``fn(frame, p2p)``, each
    on its own fresh frame made on the device before its events."""
    p2p = torch.as_tensor(p2p, dtype=torch.float32, device=device)
    frames = fresh_frames(rgbd, iters, device, seed)
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in frames]
    torch.cuda.synchronize(device)
    for x, (s, e) in zip(frames, events):
        s.record()
        fn(x, p2p)
        e.record()
    torch.cuda.synchronize(device)
    return [s.elapsed_time(e) for s, e in events]


def frame_latency_ms(fn: Callable, rgbd: Any, p2p: Any, iters: int = 10,
                     repeats: int = 5, warmup: int = 3) -> float:
    """Per-frame latency of ``fn(rgbd, p2p)`` on the card: the median over
    ``repeats`` of the mean CUDA-event time of ``iters`` calls, each on a
    fresh device-resident frame, after ``warmup`` calls. Fails without a
    card."""
    if not torch.cuda.is_available():
        raise RuntimeError("frame_latency_ms times the card: no CUDA device")
    dev = torch.device("cuda")
    p2p_d = torch.as_tensor(p2p, dtype=torch.float32, device=dev)
    for x in fresh_frames(rgbd, warmup, dev, seed=1):
        fn(x, p2p_d)
    means = [statistics.fmean(frame_times_ms(fn, rgbd, p2p_d, iters, dev,
                                             seed=2 + r))
             for r in range(repeats)]
    return statistics.median(means)


def _nbytes(tree: Any) -> int:
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_nbytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0


def cost_stats(graph: torch.nn.Module, rgbd: torch.Tensor, p2p: torch.Tensor,
               flops_graph: torch.nn.Module | None = None) -> dict:
    """{'flops': the operations ``flop_counter`` counts in one call of
    ``flops_graph`` (default ``graph``), 'bytes': the bytes of ``graph``'s
    state (parameters and persistent buffers) plus its inputs and its
    outputs}: a lower bound on what one frame moves, not a count of its
    traffic."""
    with torch.no_grad():
        with FlopCounterMode(display=False) as counter:
            (flops_graph or graph)(rgbd, p2p)
        out = graph(rgbd, p2p)
    state = sum(t.numel() * t.element_size()
                for t in graph.state_dict().values())
    return {"flops": float(counter.get_total_flops()),
            "bytes": float(state + _nbytes([rgbd, p2p]) + _nbytes(out))}


def mfu_fields(flops: float, bytes_: float, seconds: float) -> dict:
    """Roofline fields of one frame of ``seconds``: GFLOP per frame,
    achieved TFLOP/s and its share of each H100 peak (bf16 and TF32 tensor
    cores, f32 CUDA cores), the bytes' GB/s and share of HBM3, and the
    arithmetic intensity."""
    achieved = flops / seconds
    bw = bytes_ / seconds
    return {
        "gflop_per_frame": flops / 1e9,
        "achieved_tflops": achieved / 1e12,
        "share_of_bf16_peak": achieved / H100_PEAK_BF16_FLOPS,
        "share_of_tf32_peak": achieved / H100_PEAK_TF32_FLOPS,
        "share_of_f32_peak": achieved / H100_PEAK_F32_FLOPS,
        "hbm_gbps": bw / 1e9,
        "hbm_share": bw / H100_HBM_BYTES_PER_S,
        "arith_intensity": flops / max(bytes_, 1.0),
    }
