"""CLI: the deployment graph against a reference checkpoint's outputs.

Counterpart of ``scripts/runtime/parity_check.py``:

    python -m creste_public_tpu_torch.runtime.parity_check --ckpt C \\
        [--trace] [--sample data.pkl] [--expected ref.pkl] [--tiny] \\
        [--fused] [--tol 1e-3] [--device cuda|cpu]

1. reads the reference's checkpoint: a Lightning checkpoint or a bare
   state_dict, or with ``--trace`` a TorchScript trace (the released
   format), whose ``state_dict`` gives the weights;
2. maps it onto the port's state_dict (``training.torch_import``); it
   reports the keys no rule takes, the imported keys the deployment graph
   has no tensor for (dropped) and the graph's tensors the checkpoint
   lacks (left at their seeded values);
3. runs the deployment graph (``--fused``: the reward head on the kernel)
   on the sample (``--sample``: a pickle of ``rgbd`` [1, 1, H, W, 4] or
   [1, 1, 4, H, W] and ``p2p``; default the example frame);
4. compares with the expected outputs: a pickle (``--expected``), or with
   ``--trace`` the trace itself run on the sample (on the CPU); NHWC maps
   are compared to the reference's NCHW ones transposed. Each key prints
   ``OK`` or ``FAIL`` against ``--tol``, then the worst deviation.
"""
from __future__ import annotations

import argparse
import pickle
from typing import Any, Sequence

import numpy as np
import torch

from creste_public_tpu_torch.runtime.compile import (
    deployment_config,
    deployment_state,
    example_inputs,
    image_size,
)
from creste_public_tpu_torch.runtime.export import build_inference_fn
from creste_public_tpu_torch.training.torch_import import (
    import_reference_state_dict,
    load_reference_checkpoint,
    merge_into_state,
)

TRACE_KEYS = ("traversability_preds", "traversability_preds_full",
              "inpainting_sam_preds", "inpainting_sam_dynamic_preds",
              "elevation_preds", "depth_preds_metric")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--sample", default=None)
    ap.add_argument("--expected", default=None)
    ap.add_argument("--trace", action="store_true",
                    help="--ckpt is a TorchScript trace: its state_dict "
                         "gives the weights and, without --expected, the "
                         "trace run on the sample gives the reference")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--fused", action="store_true")
    ap.add_argument("--tol", type=float, default=1e-3)
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv: Sequence[str] | None = None) -> dict[str, Any]:
    """Returns {"worst": the largest deviation (None without expected
    outputs), "rows": {key: deviation}, "unmatched": the unmatched
    reference keys, "dropped": the imported keys the graph lacks,
    "seeded": the graph's keys the checkpoint lacks}."""
    args = parser().parse_args(argv)
    cfg = deployment_config(args.tiny)
    if args.sample:
        with open(args.sample, "rb") as f:
            data = pickle.load(f)
        rgbd = np.asarray(data["rgbd"], np.float32)
        p2p = np.asarray(data["p2p"], np.float32)
        if rgbd.ndim == 5 and rgbd.shape[2] == 4:  # [B,1,4,H,W] -> NHWC
            rgbd = np.transpose(rgbd, (0, 1, 3, 4, 2))
    else:
        rgbd, p2p = example_inputs(*image_size(cfg))

    traced = None
    if args.trace:
        traced = torch.jit.load(args.ckpt, map_location="cpu").eval()
        sd = traced.state_dict()
    else:
        sd = load_reference_checkpoint(args.ckpt)
    imported, unmatched = import_reference_state_dict(sd)
    target = deployment_state(cfg)
    dropped = sorted(set(imported) - set(target))
    seeded = sorted(set(target) - set(imported))
    for keys, what in ((unmatched, "unmatched reference keys"),
                       (dropped, "imported keys the deployment graph lacks "
                                 "(dropped)"),
                       (seeded, "deployment tensors the checkpoint lacks "
                                "(left at their seeded values)")):
        if keys:
            print(f"WARNING: {len(keys)} {what}, e.g.:")
            for k in keys[:10]:
                print("   ", k)
    state = merge_into_state(target, imported, require_match=False)
    out = build_inference_fn(cfg, state, args.device,
                             fused_reward=args.fused)(rgbd, p2p)
    out = {k: v.float().cpu().numpy() for k, v in out.items()}

    expected = None
    if args.expected:
        with open(args.expected, "rb") as f:
            expected = pickle.load(f)
    elif traced is not None:
        x = torch.from_numpy(np.ascontiguousarray(
            np.transpose(rgbd, (0, 1, 4, 2, 3))))  # [B, 1, 4, H, W]
        with torch.no_grad():
            tout = traced(x, torch.from_numpy(p2p))
        expected = {k: v.numpy() for k, v in tout.items()
                    if k in TRACE_KEYS and hasattr(v, "numpy")}

    rows: dict[str, float] = {}
    if expected is None:
        for k, v in sorted(out.items()):
            print(f"{k}: shape={v.shape} mean={v.mean():.4f} "
                  f"std={v.std():.4f} range=[{v.min():.3f},{v.max():.3f}]")
        return {"worst": None, "rows": rows, "unmatched": unmatched,
                "dropped": dropped, "seeded": seeded}
    for k, ref in expected.items():
        if k not in out:
            print(f"MISSING output {k}")
            continue
        ref = np.asarray(ref, np.float32)
        got = out[k]
        if got.shape != ref.shape and got.ndim == 4:
            got = np.transpose(got, (0, 3, 1, 2))  # NHWC -> NCHW
        rows[k] = float(np.abs(got - ref).max())
        flag = "OK  " if rows[k] <= args.tol else "FAIL"
        print(f"{flag} {k}: max|diff|={rows[k]:.2e}")
    worst = max(rows.values(), default=0.0)
    print(f"worst deviation: {worst:.2e} (target <= {args.tol})")
    return {"worst": worst, "rows": rows, "unmatched": unmatched,
            "dropped": dropped, "seeded": seeded}


if __name__ == "__main__":
    main()
