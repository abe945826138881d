"""CLI: export the deployment inference graph with ``torch.export``.

Counterpart of ``scripts/runtime/compile.py`` (the reference's
``torch.jit.trace`` step; the JAX package's StableHLO export):

    python -m creste_public_tpu_torch.runtime.compile \\
        [--out creste_rgbd_export.pt2] [--ckpt D] [--tiny] [--fused] \\
        [--bf16] [--native-dir D [--native-outputs k1,k2]] \\
        [--latency] [--device cuda|cpu]

It builds MaxEntIRL with ``solve_mdp=False`` (``presets.
traversability_model_config``, or its tiny preset with ``--tiny``) with
seeded weights or a port checkpoint (``--ckpt``: a ``training.checkpoint``
step directory or its ``state.pt``), exports it on the example frame,
reloads the program and runs it (the dry run), and optionally writes the
native artifact and times the engine. It runs on the card unless
``--device cpu``.
"""
from __future__ import annotations

import argparse
import os
from typing import Any, Sequence

import numpy as np
import torch

from creste_public_tpu_torch import weights
from creste_public_tpu_torch.config import presets
from creste_public_tpu_torch.models.lfd import MaxEntIRL
from creste_public_tpu_torch.runtime.export import (
    InferenceEngine,
    build_inference_graph,
    export_inference_graph,
    export_native_artifacts,
    load_exported,
)
from creste_public_tpu_torch.training.checkpoint import load_state_file


def deployment_config(tiny: bool) -> dict:
    """The deployment graph's config: the production preset, or the tiny
    one; ``solve_mdp`` off."""
    cfg = (presets.tiny_traversability_config() if tiny
           else presets.traversability_model_config()).to_dict()
    cfg["solve_mdp"] = False
    return cfg


def image_size(cfg: dict) -> tuple[int, int]:
    h, w = cfg["vision_backbone"]["vision_backbone"]["effnet_cfgs"][
        "image_size"]
    return int(h), int(w)


def example_inputs(h: int, w: int, B: int = 1, depth_mm: float = 20000.0,
                   seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """RGBD [B, 1, h, w, 4] (RGB uniform, depth uniform up to ``depth_mm``)
    and a forward-looking pinhole p2p [B, 1, 4, 4] (fx = fy = 0.9 w)."""
    rng = np.random.default_rng(seed)
    rgbd = rng.uniform(0, 1, (B, 1, h, w, 4)).astype(np.float32)
    rgbd[..., 3] *= depth_mm
    fx = fy = 0.9 * w
    kinv = np.array(
        [[1 / fx, 0, -w / 2 / fx], [0, 1 / fy, -h / 2 / fy], [0, 0, 1.0]])
    rot = np.array([[0, 0, 1.0], [-1, 0, 0], [0, -1, 0]])
    p2p = np.eye(4, dtype=np.float32)
    p2p[:3, :3] = (rot @ kinv).astype(np.float32)
    return rgbd, np.tile(p2p, (B, 1, 1, 1))


def deployment_state(cfg: dict, ckpt: str | None = None
                     ) -> dict[str, torch.Tensor]:
    """The graph's weights: a port checkpoint's model state, or
    ``weights.init_weights`` with seed 0 (on the CPU)."""
    if ckpt:
        return load_state_file(ckpt)["model"]
    return weights.init_weights(MaxEntIRL(cfg), 0).state_dict()


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="creste_rgbd_export.pt2")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--latency", action="store_true")
    ap.add_argument("--bf16", action="store_true",
                    help="the mixed-precision graph: bf16 stream and bf16 "
                         "non-norm weights, f32 islands (runtime/"
                         "precision.py; opt-in, not held to the f32 bar)")
    ap.add_argument("--fused", action="store_true",
                    help="the reward head as creste::msfcn_head, the CUDA "
                         "kernel on the card (BN folded)")
    ap.add_argument("--native-dir", default=None,
                    help="also write the native artifact (program.pt2 "
                         "with the weights, manifest.txt)")
    ap.add_argument("--native-outputs", default=None,
                    help="comma-separated output keys of the native "
                         "artifact (default: all)")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv: Sequence[str] | None = None) -> dict[str, Any]:
    args = parser().parse_args(argv)
    cfg = deployment_config(args.tiny)
    rgbd, p2p = example_inputs(*image_size(cfg))
    state = deployment_state(cfg, args.ckpt)
    dtype = "bfloat16" if args.bf16 else None
    graph = build_inference_graph(cfg, state, args.device, args.fused,
                                  compute_dtype=dtype)
    export_inference_graph(graph, rgbd, p2p, args.out)
    nbytes = os.path.getsize(args.out)
    print(f"exported {nbytes / 1e6:.2f} MB torch.export program to "
          f"{args.out}", flush=True)

    dev = next(graph.parameters()).device
    x = torch.from_numpy(rgbd).to(dev)
    p = torch.from_numpy(p2p).to(dev)
    with torch.no_grad():
        eager = graph(x, p)
        got = load_exported(args.out).module()(x, p)
    dev_max = max(float((got[k].float() - eager[k].float()).abs().max())
                  for k in eager)
    print(f"reload: {len(got)} outputs, max|reloaded - eager| "
          f"{dev_max:.3e}", flush=True)
    summary: dict[str, Any] = {"program_bytes": nbytes, "outputs": len(got),
                               "reload_max_abs": dev_max}

    if args.native_dir:
        keys = args.native_outputs.split(",") if args.native_outputs else None
        info = export_native_artifacts(cfg, state, rgbd, p2p, args.native_dir,
                                       args.fused, keys, compute_dtype=dtype,
                                       device=args.device)
        print(f"native artifact: {info['program_bytes'] / 1e6:.2f} MB "
              f"program, {info['num_outputs']} outputs, "
              f"{info['manifest_lines']} manifest lines -> "
              f"{args.native_dir}", flush=True)
        summary["native"] = info

    if args.latency:
        eng = InferenceEngine(cfg, state, args.device, args.fused,
                              compute_dtype=dtype)
        summary["latency"] = eng.latency_stats(rgbd, p2p)
        print(summary["latency"], flush=True)
    return summary


if __name__ == "__main__":
    main()
