"""Time ``assemble_rgbd`` on the card for each tile shape of a list: the
kernel's device time per launch under the profiler and by CUDA events with
the launches queued behind a sleep (so that the wrapper's host time does
not count), each shape's result held against the plain version to the
bit. It picks nothing: ``frame_kernel.TILE_SHAPES`` is set by hand from
what it prints.

    python -m creste_public_tpu_torch.ops.frame_tile_sweep \\
        [--shapes 16x64,8x64] [--frame 1024x1224] [--size 512x612] \\
        [--sub 420] [--iters 50]

Defaults: the CODa reader's frame (1024x1224, 4:2:0, with depth) to
512x612, ``TILE_SHAPES``' first five shapes. Random planes from a seed.
Prints the card's name and power limit first, then one line per shape.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess

import torch

from creste_public_tpu_torch.ops import frame_kernel as fk

SUBSAMPLING = {"444": (1, 1), "422": (2, 1), "420": (2, 2)}


def _pair(text: str) -> tuple[int, int]:
    a, b = text.lower().split("x")
    return int(a), int(b)


def plan_with(shape: tuple[int, int], H: int, W: int, h: int, w: int,
              sh: int, sv: int) -> tuple[int, int]:
    """Put ``shape`` first in ``TILE_SHAPES`` and drop the cached plans;
    returns the tile the plan then takes (another one when it does not
    fit)."""
    fk.TILE_SHAPES = (shape,) + tuple(s for s in fk.TILE_SHAPES
                                      if s != shape)
    fk.tile_plan.cache_clear()
    fk.device_tables.cache_clear()
    th, tw = fk.tile_plan(H, W, h, w, sh, sv)["layout"][:2]
    return int(th), int(tw)


def device_us(call, n: int) -> float:
    """Device µs per launch of ``assemble_rgbd_kernel`` under the profiler
    over ``n`` calls (raises if it recorded under half of them)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            call()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    times = [e.self_device_time_total for e in prof.events()
             if e.device_type == cuda and "assemble_rgbd" in e.key]
    if len(times) < n // 2:
        raise RuntimeError(f"the profiler recorded {len(times)} of {n} "
                           "launches")
    return sum(times) / len(times)


def queued_us(call, n: int, reps: int = 3) -> float:
    """CUDA-event µs per launch of ``n`` launches queued behind a sleep,
    the median of ``reps``."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(20_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            call()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) * 1e3 / n)
    return statistics.median(out)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", default=",".join(
        f"{a}x{b}" for a, b in fk.TILE_SHAPES[:5]))
    ap.add_argument("--frame", default="1024x1224")
    ap.add_argument("--size", default="512x612")
    ap.add_argument("--sub", default="420", choices=list(SUBSAMPLING))
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("frame_tile_sweep times the card's kernel: no "
                         "CUDA device")
    dev = torch.device("cuda", torch.cuda.current_device())
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    (H, W), (h, w) = _pair(args.frame), _pair(args.size)
    sh, sv = SUBSAMPLING[args.sub]
    g = torch.Generator().manual_seed(0)
    ch, cw = -(-H // sv), -(-W // sh)
    planes = [torch.randint(0, 256, s, generator=g, dtype=torch.uint8)
              for s in ((H, W), (ch, cw), (ch, cw))]
    depth = torch.randint(0, 65536, (H, W), generator=g,
                          dtype=torch.int32).to(torch.uint16)
    want = fk.assemble_rgbd_plain(fk.ycc_to_rgb_plain(*planes), depth,
                                  (h, w))
    on_card = [p.to(dev) for p in planes]
    d = depth.to(dev)
    for shape in map(_pair, args.shapes.split(",")):
        tile = plan_with(shape, H, W, h, w, sh, sv)

        def call():
            return fk.assemble_rgbd_cuda(on_card, d, (h, w))

        equal = torch.equal(call().cpu(), want)
        for _ in range(5):
            call()
        prof = device_us(call, args.iters)
        queued = queued_us(call, args.iters)
        print(f"tile {shape[0]}x{shape[1]} (planned {tile[0]}x{tile[1]}, "
              f"{fk.tile_plan(H, W, h, w, sh, sv)['bytes']} B of shared "
              f"memory): {prof:.2f} µs profiled, {queued:.2f} µs queued; "
              f"equal to the plain version: {equal}", flush=True)


if __name__ == "__main__":
    main()
