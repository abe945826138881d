#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (creste_public_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing one line before the final one:

1. build: nvcc builds every kernel source of the port (csrc/*.cu).
2. kernel check: the reward-head kernel against its plain PyTorch version
   at [1,64,128,40] and [3,32,64,40].
3. main path: the production deployment graph
   (presets.traversability_model_config, RGBD [1,1,512,612,4]) through
   runtime.export.build_inference_fn, with seeded random weights; checks
   that the kernel was launched, that the outputs are finite with the JAX
   package's shapes, and that the reward agrees with the same graph run on
   the CPU.
4. timing: CUDA-event times of the kernel, its plain version, the library
   convolution and the whole frame, beside the card's name and power limit.

Every parity phase runs with TF32 off for cuDNN convolutions and for
matmuls (torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.
allow_tf32 = False), so the card computes in f32 like the reference.

It then prints the kernels' JSON line, the card line
(nvidia-smi name, power.limit) and, last, {"ok": true, "device": {...}}.
Any failed phase raises and exits non-zero. Without CUDA it exits 1.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

SEED = 0
# the H100 SXM's published peaks (NVIDIA data sheet, dense, 700 W)
PEAK_F32_FLOPS = 67e12  # f32 on CUDA cores: the kernel's FMAs
PEAK_BYTES = 3.35e12  # HBM3
# kernel vs plain version: f32 with sums in another order
KERNEL_RTOL, KERNEL_ATOL = 1e-4, 1e-5
# card vs CPU, as max|d| / max(1, max|ref|): one stage from the same input
# (f32, cuDNN's and the CPU's sums in other orders, atomic splat adds), and
# the whole frame (see the main-path phase for why it is looser)
STAGE_RTOL = 1e-3
FRAME_RTOL = 1e-2


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", flush=True)
    sys.exit(1)


def example_inputs(h: int, w: int, B: int = 1):
    """RGBD with depth in mm and a pinhole p2p (a copy of the JAX package's
    ``__graft_entry__._example_inputs``)."""
    rng = np.random.default_rng(0)
    rgbd = rng.uniform(0, 1, (B, 1, h, w, 4)).astype(np.float32)
    rgbd[..., 3] *= 20000.0
    fx = fy = 0.9 * w
    kinv = np.array(
        [[1 / fx, 0, -w / 2 / fx], [0, 1 / fy, -h / 2 / fy], [0, 0, 1.0]])
    rot = np.array([[0, 0, 1.0], [-1, 0, 0], [0, -1, 0]])
    p2p = np.eye(4, dtype=np.float32)
    p2p[:3, :3] = (rot @ kinv).astype(np.float32)
    return rgbd, np.tile(p2p, (B, 1, 1, 1))


def time_ms(torch, f, iters: int = 20, reps: int = 5) -> float:
    """Median over ``reps`` of the mean CUDA-event time of ``iters`` calls."""
    for _ in range(3):
        f()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(iters):
            f()
        e.record()
        e.synchronize()
        out.append(s.elapsed_time(e) / iters)
    return statistics.median(out)


def layer_bound(x_shape, layer) -> tuple[float, float]:
    """(flops, bytes) one folded layer needs: the multiply-adds of the
    in-bounds taps (padding taps read zeros and are not work) plus the
    3-op epilogue; each input, weight and output byte once."""
    B, H, W, Ci = x_shape
    kh, kw, _, Co = layer["kernel"].shape
    rows = sum(H - abs(dy - kh // 2) for dy in range(kh))
    cols = sum(W - abs(dx - kw // 2) for dx in range(kw))
    flops = 2.0 * B * rows * cols * Ci * Co + 3.0 * B * H * W * Co
    nbytes = 4.0 * (B * H * W * Ci + kh * kw * Ci * Co + 2 * Co
                    + B * H * W * Co)
    return flops, nbytes


def to_device(folded, dev):
    return {k: [{**ly, "kernel": ly["kernel"].to(dev), "a": ly["a"].to(dev),
                 "b": ly["b"].to(dev)} for ly in v]
            for k, v in folded.items()}


def max_rel(a, b) -> tuple[float, float]:
    d = float((a.float() - b.float()).abs().max())
    return d, d / max(1.0, float(b.float().abs().max()))


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a GPU")

    from creste_public_tpu_torch import weights
    from creste_public_tpu_torch.config import presets
    from creste_public_tpu_torch.models.blocks.convnets import MultiScaleFCN
    from creste_public_tpu_torch.models.blocks.vin import build_input_view
    from creste_public_tpu_torch.models.lfd import MaxEntIRL
    from creste_public_tpu_torch.ops import _build
    from creste_public_tpu_torch.ops import reward_kernel as rk
    from creste_public_tpu_torch.runtime.export import build_inference_fn

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = card.splitlines()[0]
    print(f"setup: torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} ({card}); TF32 off for "
          "cuDNN convolutions and matmuls", flush=True)

    # 1. build
    t0 = time.perf_counter()
    report = _build.build()
    for name, r in report.items():
        ptxas = [ln.strip() for ln in r["log"].splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"build: {name} {r['seconds']:.1f} s; ptxas: {ptxas}",
              flush=True)
    print(f"phase build: ok, {len(report)} source(s) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # 2. kernel check: every layer and the whole head, kernel vs plain
    cfg = presets.traversability_model_config().to_dict()
    cfg["solve_mdp"] = False
    head_cfg = cfg["traversability_head"]["net_kwargs"]["reward_cfg"]
    msfcn = weights.init_weights(MultiScaleFCN(head_cfg["net_kwargs"]), SEED)
    folded = to_device(rk.fold_msfcn_params(msfcn), dev)
    g = torch.Generator().manual_seed(SEED)
    for shape in [(1, 64, 128, 40), (3, 32, 64, 40)]:
        x = torch.randn(shape, generator=g).to(dev)
        pairs = []

        def both(t, ly):
            ref = rk.conv_affine_plain(t, ly)
            pairs.append((rk.conv_affine_cuda(t, ly), ref))
            return ref.contiguous()

        rk.msfcn_chain(folded, x, both)
        pairs.append((rk.msfcn_fused_apply(folded, x),
                      rk.msfcn_plain(folded, x)))
        torch.cuda.synchronize()
        worst = 0.0
        for got, ref in pairs:
            if got.shape != ref.shape:
                fail(f"kernel shape {tuple(got.shape)} != {tuple(ref.shape)}")
            err = (got - ref).abs()
            if not bool((err <= KERNEL_ATOL + KERNEL_RTOL * ref.abs()).all()):
                fail(f"kernel disagrees with its plain version at {shape}: "
                     f"max|d| {float(err.max()):.3e}")
            worst = max(worst, float(err.max()))
        print(f"phase kernel check {list(shape)}: ok, {len(pairs) - 1} layers "
              f"+ head, max|d| {worst:.3e} (tol {KERNEL_ATOL} + "
              f"{KERNEL_RTOL}*|ref|)", flush=True)

    # 3. main path at the production configuration
    h, w = cfg["vision_backbone"]["vision_backbone"]["effnet_cfgs"][
        "image_size"]
    rgbd, p2p = example_inputs(h, w)
    model = weights.init_weights(MaxEntIRL(cfg), SEED)
    state = model.state_dict()
    folded_main = to_device(
        rk.fold_msfcn_params(model.traversability_head.r), dev)
    fn = build_inference_fn(cfg, state, device="cuda")
    rgbd_d = torch.from_numpy(rgbd).to(dev)
    p2p_d = torch.from_numpy(p2p).to(dev)
    torch.cuda.synchronize()
    rk.conv_affine_cuda.launches = 0
    out = fn(rgbd_d, p2p_d)
    torch.cuda.synchronize()
    launches = rk.conv_affine_cuda.launches
    if launches == 0:
        fail("the main path launched the reward-head kernel 0 times")
    expected = {
        "traversability_preds": (1, 64, 128, 1),
        "traversability_preds_full": (1, 256, 256, 1),
        "input_view": (1, 64, 128, 40),
        "bev_features": (1, 256, 256, 96),
        "bev_densities": (1, 256, 256, 1),
        "depth_preds_metric": (1, 128, 153),
        "depth_preds_feats": (1, 128, 153, 256),
        "dino_pe_feats": (1, 1, 128, 153, 128),
        "inpainting_sam_preds": (1, 256, 256, 32),
        "inpainting_sam_dynamic_preds": (1, 256, 256, 6),
        "elevation_preds": (1, 256, 256, 2),
    }
    for k, shp in expected.items():
        if tuple(out[k].shape) != shp:
            fail(f"{k} has shape {tuple(out[k].shape)}, expected {shp}")
        if not bool(torch.isfinite(out[k].float()).all()):
            fail(f"{k} has non-finite values")
    n_in_range = int((out["bev_densities"] > 0).sum())
    print(f"phase main path: ok, kernel launches {launches}, "
          f"{len(expected)} outputs finite with the reference shapes, "
          f"{n_in_range} BEV cells hit, reward max|r| "
          f"{float(out['traversability_preds'].abs().max()):.4e}",
          flush=True)

    # card vs CPU. End to end the reward is held to FRAME_RTOL: with random
    # weights the depth head's logits are large, so the ~1e-6 relative
    # difference of the backbone features becomes mm-scale shifts of the
    # softmax-expectation depth, which move the bilinear splat weights.
    # Each stage is also run on the CPU from the card's own input to that
    # stage and held to STAGE_RTOL.
    t0 = time.perf_counter()
    out_cpu = build_inference_fn(cfg, state, device="cpu")(rgbd, p2p)
    cpu_s = time.perf_counter() - t0
    for k in expected:
        d, rel = max_rel(out[k].cpu(), out_cpu[k])
        print(f"  card vs CPU end to end {k}: max|d| {d:.3e}, "
              f"max|d|/max(1,max|ref|) {rel:.3e}", flush=True)
    model.eval()
    c = {k: v.cpu() for k, v in out.items()}
    with torch.no_grad():
        splat = model.backbone.cam2map(
            c["depth_preds_metric"].reshape(1, 1, *c["depth_preds_metric"]
                                            .shape[1:]),
            c["depth_preds_feats"].reshape(1, 1, *c["depth_preds_feats"]
                                           .shape[1:]),
            torch.from_numpy(p2p))
        dec = model.backbone.bevclassifier(c)
        head = model.traversability_head(c)
    stages = [
        ("backbone depth_preds_feats", c["depth_preds_feats"],
         out_cpu["depth_preds_feats"]),
        ("backbone dino_pe_feats", c["dino_pe_feats"],
         out_cpu["dino_pe_feats"]),
        ("backbone depth_preds_metric", c["depth_preds_metric"],
         out_cpu["depth_preds_metric"]),
        ("splat bev_features", c["bev_features"], splat["bev_features"]),
        ("splat bev_densities", c["bev_densities"], splat["bev_densities"]),
    ] + [(f"decoder {k}", c[k], dec[k]) for k in dec if k.endswith("_preds")
         ] + [(f"head {k}", c[k], head[k]) for k in head]
    for name, got, ref in stages:
        d, rel = max_rel(got, ref)
        print(f"  card vs CPU stage {name}: max|d| {d:.3e}, "
              f"max|d|/max(1,max|ref|) {rel:.3e}", flush=True)
        if rel > STAGE_RTOL:
            fail(f"stage {name} on the card differs from the CPU: "
                 f"{rel:.3e} > {STAGE_RTOL}")
    for k in ("traversability_preds", "traversability_preds_full"):
        _, rel = max_rel(out[k].cpu(), out_cpu[k])
        if rel > FRAME_RTOL:
            fail(f"{k} on the card differs from the CPU run: "
                 f"{rel:.3e} > {FRAME_RTOL}")
    _, rel = max_rel(out["traversability_preds"].cpu(),
                     out_cpu["traversability_preds"])
    print(f"phase card vs CPU: ok, {len(stages)} stages <= {STAGE_RTOL}, "
          f"end-to-end reward max|d|/max(1,max|ref|) {rel:.3e} <= "
          f"{FRAME_RTOL} (CPU frame {cpu_s:.1f} s)", flush=True)

    # 4. timing, at the main path's own reward-head inputs
    layers = []

    def record(t, ly):
        layers.append((t, ly))
        return rk.conv_affine_plain(t, ly).contiguous()

    rk.msfcn_chain(folded_main, out["input_view"], record)
    k_ms = p_ms = lib_ms = flops = nbytes = 0.0
    err = 0.0
    for t, ly in layers:
        f_, b_ = layer_bound(tuple(t.shape), ly)
        flops += f_
        nbytes += b_
        # the library yardstick: one F.conv2d (cuDNN, TF32 off) per layer
        # on NCHW-contiguous copies, cuDNN's own layout (copies made here)
        w_lib = ly["kernel"].permute(3, 2, 0, 1).contiguous()
        x_lib = t.permute(0, 3, 1, 2).contiguous()
        pad = (ly["kernel"].shape[0] // 2, ly["kernel"].shape[1] // 2)
        k_ms += time_ms(torch, lambda: rk.conv_affine_cuda(t, ly))
        p_ms += time_ms(torch, lambda: rk.conv_affine_plain(t, ly))
        lib_ms += time_ms(torch, lambda: torch.nn.functional.conv2d(
            x_lib, w_lib, padding=pad))
        err = max(err, float((rk.conv_affine_cuda(t, ly)
                              - rk.conv_affine_plain(t, ly)).abs().max()))
    t_flop = flops / PEAK_F32_FLOPS * 1e3
    t_byte = nbytes / PEAK_BYTES * 1e3
    bound_ms = max(t_flop, t_byte)
    head_ms = time_ms(torch, lambda: rk.msfcn_fused_apply(
        folded_main, out["input_view"]))
    head_plain_ms = time_ms(torch, lambda: rk.msfcn_plain(
        folded_main, out["input_view"]))
    print(f"phase timing kernel: {len(layers)} layers {k_ms * 1e3:.1f} us "
          f"(plain {p_ms * 1e3:.1f} us, cuDNN conv2d only "
          f"{lib_ms * 1e3:.1f} us, bound {bound_ms * 1e3:.2f} us by "
          f"{'operations' if t_flop >= t_byte else 'bytes'}: "
          f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.3f} MB); whole head "
          f"{head_ms * 1e3:.1f} us (plain {head_plain_ms * 1e3:.1f} us) "
          f"[{card}]", flush=True)

    frame_ms = time_ms(torch, lambda: fn(rgbd_d, p2p_d), iters=10, reps=5)
    # where the frame's time goes: each stage of the same graph on its own
    cm = MaxEntIRL(cfg)
    cm.load_state_dict(state, strict=True)
    cm.to(dev).eval()
    depth4 = out["depth_preds_metric"].reshape(1, 1, 128, 153)
    feats5 = out["depth_preds_feats"].reshape(1, 1, 128, 153, 256)
    rcfg = cm.traversability_head.reward_cfg
    with torch.no_grad():
        stages = {
            "backbone (EffNet-b0 + Up, depth head, DINO head)":
                lambda: cm.backbone.depthcomp(rgbd_d, p2p_d),
            "splat (backproject, z-MLP, fusion, mean scatter)":
                lambda: cm.backbone.cam2map(depth4, feats5, p2p_d),
            "BEV decoder (ResNet18 + 3 DeconvHeads)":
                lambda: cm.backbone.bevclassifier(out),
            "reward (input view + folded head on the kernel)":
                lambda: rk.msfcn_fused_apply(folded_main, build_input_view(
                    out, rcfg["input_keys"], int(rcfg["ds"]))),
        }
        for name, f in stages.items():
            print(f"  stage time {name}: {time_ms(torch, f, 10, 3):.3f} ms "
                  f"[{card}]", flush=True)
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(5):
                fn(rgbd_d, p2p_d)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    print(f"  profile 5 frames: device busy {dev_us / 1e3:.2f} ms of "
          f"{wall_us / 1e3:.2f} ms wall, idle share "
          f"{max(0.0, 1 - dev_us / wall_us):.3f}; top kernels: "
          + "; ".join(f"{e.key[:48]} {e.self_device_time_total / 5e3:.3f} "
                      "ms/frame" for e in top), flush=True)
    torch.backends.cudnn.allow_tf32 = True
    frame_tf32_ms = time_ms(torch, lambda: fn(rgbd_d, p2p_d), iters=10,
                            reps=5)
    torch.backends.cudnn.allow_tf32 = False
    print(f"phase timing frame: {frame_ms:.3f} ms/frame = "
          f"{1e3 / frame_ms:.2f} Hz f32 (TF32 off); {frame_tf32_ms:.3f} "
          f"ms/frame = {1e3 / frame_tf32_ms:.2f} Hz with cuDNN TF32 on; "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB [{card}]", flush=True)

    print(json.dumps({"kernels": [{
        "name": "msfcn_conv_affine",
        "route": "cuda",
        "source": "creste_public_tpu_torch/csrc/msfcn_chain.cu",
        "replaces": "creste_public_tpu/ops/reward_pallas.py:83",
        "launches": launches,
        "max_abs_err": err,
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if t_flop >= t_byte else "bytes",
        "library_ms": lib_ms,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
