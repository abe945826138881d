"""Build the libtorch serving host and run it over a native artifact.

The host (``csrc/serve_host.cpp``) is a C++ process with no Python in it:
it loads the AOTInductor package that ``compile --native-dir D
--native-package`` writes beside ``manifest.txt`` and serves it, the reward
head running as the C++ registration of ``creste::msfcn_head``
(``csrc/msfcn_head_op.cpp``: the kernel of ``csrc/msfcn_chain.cu`` on the
card). This module builds both from the checkout's sources
(``ops._build.build_host``), runs the host, and parses its one JSON line:
the port's version of the JAX end-to-end script's native leg, which runs
``native/creste_serve`` over its artifact. ``eager_stages`` runs each
stage of the eager graph from the host's dumped input to it, to hold a
package stage by stage.

    python -m creste_public_tpu_torch.runtime.native_serve --artifact D \\
        [--device cuda|cpu] [--iters 30] [--warmup 3] [--distinct 8] \\
        [--pipeline 2] [--in rgbd=F,p2p=G] [--dump DIR] [--fetch K1,K2] \\
        [--tf32]

It serves on the card unless ``--device cpu`` (then the package must have
been compiled on the CPU); the host runs on as many CPU threads as this
process's torch does.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from creste_public_tpu_torch.models.blocks.vin import (
    build_input_view,
    full_reward_map,
)
from creste_public_tpu_torch.ops import _build
from creste_public_tpu_torch.runtime.export import MANIFEST_FILE
from creste_public_tpu_torch.utils.device import resolve_device

_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16,
           "f16": torch.float16, "s32": torch.int32, "s64": torch.int64,
           "u8": torch.uint8, "pred": torch.bool}


def read_manifest(artifact: str) -> dict[str, Any]:
    """The manifest's inputs and outputs, each ``name -> (dtype token,
    dims)`` in file order, and its ``package`` line (file, device) or
    None."""
    spec: dict[str, Any] = {"input": {}, "output": {}, "package": None}
    with open(os.path.join(artifact, MANIFEST_FILE)) as f:
        for line in f:
            kind, *rest = line.split()
            if kind in ("input", "output"):
                name, dtype, dims = rest
                spec[kind][name] = (dtype, tuple(int(d) for d in
                                                 dims.split(",")))
            elif kind == "package":
                spec["package"] = tuple(rest)
    return spec


def write_inputs(directory: str, arrays: Mapping[str, Any],
                 artifact: str | None = None) -> dict[str, str]:
    """Each array as a raw row-major file ``directory/<name>.bin`` in the
    dtype ``artifact``'s manifest gives its input (f32 without an
    artifact), the host's ``--in`` format; returns name -> path."""
    dtypes = (read_manifest(artifact)["input"] if artifact else {})
    os.makedirs(directory, exist_ok=True)
    paths = {}
    for name, a in arrays.items():
        paths[name] = os.path.join(directory, f"{name}.bin")
        t = torch.as_tensor(np.asarray(a)).to(
            _DTYPES[dtypes.get(name, ("f32",))[0]]).contiguous()
        t.view(torch.uint8).numpy().tofile(paths[name])
    return paths


def read_dump(dump_dir: str, artifact: str) -> dict[str, torch.Tensor]:
    """The host's ``--dump`` files as tensors of the manifest's dtypes and
    dims."""
    out = {}
    for name, (dtype, dims) in read_manifest(artifact)["output"].items():
        with open(os.path.join(dump_dir, f"{name}.bin"), "rb") as f:
            data = bytearray(f.read())
        out[name] = torch.frombuffer(data, dtype=_DTYPES[dtype]).reshape(dims)
    return out


def eager_stages(graph: torch.nn.Module, got: Mapping[str, torch.Tensor],
                 p2p: Any) -> dict[str, tuple[torch.Tensor, torch.Tensor]]:
    """Each stage of ``graph`` (the ``InferenceGraph`` a package was
    exported from) after its trunk, run eagerly from the host's own
    outputs (``got``, ``read_dump``'s) as that stage's input: the depth
    head from the trunk's features, the splat from the metric depth and
    the features, the decoder from the BEV grid, the input view from the
    decoder's maps, and the full reward map from the reward. Returns
    ``"<stage> <key>" -> (eager, host)`` for each key the host served,
    both on the CPU, in the graph's dtypes (a bf16 stream's maps in bf16,
    its f32 islands in f32)."""
    bb = graph.model.backbone
    dev = next(graph.parameters()).device
    fed = {k: v.to(dev) for k, v in got.items()}
    p2p = torch.as_tensor(p2p, dtype=torch.float32, device=dev)
    B, N = p2p.shape[:2]
    feats = fed[bb.splat_key]
    Hs, Ws, Z = feats.shape[1:]
    depth_model = getattr(bb.depthcomp, "depthcomp", bb.depthcomp)
    Ho, Wo = fed[graph.input_keys[0]].shape[1:3]
    with torch.no_grad():
        stages = {
            "depth head": depth_model.predict_depth(
                fed["depth_preds_feats"].permute(0, 3, 1, 2)),
            "splat": bb.cam2map(
                fed["depth_preds_metric"].reshape(B, N, Hs, Ws),
                feats.reshape(B, N, Hs, Ws, Z), p2p),
            "decoder": bb.bevclassifier(fed),
            "input view": {"input_view": build_input_view(
                fed, graph.input_keys, graph.ds)},
            "reward map": {f"{graph.prefix}_full": full_reward_map(
                fed[graph.prefix], Ho, Wo)},
        }
    return {f"{stage} {k}": (v.cpu(), got[k])
            for stage, outs in stages.items() for k, v in outs.items()
            if k in got}


def host_argv(artifact: str, device: str = "cuda", iters: int = 30,
              warmup: int = 3, distinct: int = 8, pipeline: int = 2,
              inputs: Mapping[str, str] | None = None,
              dump: str | None = None, fetch: Sequence[str] | None = None,
              tf32: bool = False) -> list[str]:
    """The host's options (see ``csrc/serve_host.cpp``)."""
    argv = ["--artifact", artifact, "--device", device, "--iters",
            str(iters), "--warmup", str(warmup), "--distinct", str(distinct),
            "--pipeline", str(pipeline)]
    if inputs:
        argv += ["--in", ",".join(f"{k}={v}" for k, v in inputs.items())]
    if dump:
        argv += ["--dump", dump]
    if fetch:
        argv += ["--fetch", ",".join(fetch)]
    return argv + (["--tf32"] if tf32 else [])


def run_host(artifact: str, device: str = "cuda", timeout: float = 600.0,
             **options: Any) -> dict[str, Any]:
    """Builds the host for ``device`` ("cuda" or "cpu"; from the checkout's
    sources unless already built) and runs it over ``artifact`` with
    ``options`` (``host_argv``'s keywords); returns its JSON line with the
    build's ``build_s``. ``--dump`` writes into an existing directory,
    created here. Raises with the host's stderr when it exits non-zero."""
    built = _build.build_host(resolve_device(device).type == "cuda")
    if options.get("dump"):
        os.makedirs(options["dump"], exist_ok=True)
    # a TMPDIR of its own, removed after: the package loader unpacks the
    # package there and leaves it behind
    with tempfile.TemporaryDirectory(prefix="creste_host_") as tmp:
        env = dict(os.environ, TMPDIR=tmp,
                   OMP_NUM_THREADS=str(torch.get_num_threads()))
        r = subprocess.run([built["host"], *host_argv(artifact, device,
                                                      **options)],
                           capture_output=True, text=True, timeout=timeout,
                           env=env)
    if r.returncode != 0:
        raise RuntimeError(f"the host exited {r.returncode}:\n"
                           f"{r.stderr[-4000:]}")
    report = json.loads(r.stdout.strip().splitlines()[-1])
    report["build_s"] = built["seconds"]
    return report


def main(argv: Sequence[str] | None = None) -> dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--artifact", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--distinct", type=int, default=8)
    ap.add_argument("--pipeline", type=int, default=2)
    ap.add_argument("--in", dest="inputs", default=None,
                    help="name=file,... raw row-major inputs")
    ap.add_argument("--dump", default=None)
    ap.add_argument("--fetch", default=None,
                    help="k1,k2: the outputs each streamed frame reads back "
                         "(default: every output)")
    ap.add_argument("--tf32", action="store_true",
                    help="let cuDNN and cuBLAS compute f32 in TF32")
    args = ap.parse_args(argv)
    inputs = (dict(kv.split("=", 1) for kv in args.inputs.split(","))
              if args.inputs else None)
    report = run_host(args.artifact, args.device, iters=args.iters,
                      warmup=args.warmup, distinct=args.distinct,
                      pipeline=args.pipeline, inputs=inputs, dump=args.dump,
                      fetch=args.fetch.split(",") if args.fetch else None,
                      tf32=args.tf32)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
