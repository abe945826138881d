"""The deployment inference graph (RGBD + p2p -> BEV reward), its
``torch.export`` artifact and the serving engine.

Counterpart of ``creste_public_tpu/runtime/export.py``:

- ``build_inference_graph`` / ``build_inference_fn``: MaxEntIRL with
  ``solve_mdp=False``; with ``fused_reward`` the BN-folded reward head runs
  as the operator ``creste::msfcn_head`` (``ops.reward_kernel``: the
  hand-written CUDA kernel on the card, its plain version on the CPU), with
  ``fold_bn`` every other BatchNorm is the folded ``x * w + b``
  (``convnets.fold_batch_norms``), and with ``compute_dtype`` the opt-in
  bf16 stream (``runtime.precision``);
- ``export_inference_graph``: ``torch.export`` of the graph, saved with
  ``torch.export.save``;
- ``export_native_artifacts``: the program with its weights inside, and a
  ``manifest.txt`` of its inputs and outputs in the JAX package's line
  format (``input|output <name> <dtype token> <dims>``); with ``package``
  also the AOTInductor package that the libtorch host
  (``csrc/serve_host.cpp``, ``runtime.native_serve``) serves
  (``package_for_host``);
- ``load_exported``: reloads a saved program (importing this module
  registers the operator it calls);
- ``InferenceEngine``: the graph and its weights on the device, ``step``,
  ``warmup`` and ``latency_stats`` (CUDA events on the card);
- ``build_spatial_inference_fn``: the same graph with one frame's width
  split across the ranks of a spatial mesh (``parallel.spatial``).

The graph takes f32 RGBD [B, 1, H, W, 4] (depth in mm) and p2p
[B, 1, 4, 4] and returns NHWC tensors. cuDNN runs f32 convolutions in TF32
unless ``torch.backends.cudnn.allow_tf32`` is False; the port's parity
numbers are taken with it False.
"""
from __future__ import annotations

import os
import time
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch
from torch import nn

from creste_public_tpu_torch.models.blocks.convnets import fold_batch_norms
from creste_public_tpu_torch.models.blocks.vin import (
    build_input_view,
    full_reward_map,
)
from creste_public_tpu_torch.models.depth_completion import stream_dtype
from creste_public_tpu_torch.models.lfd import MaxEntIRL
from creste_public_tpu_torch.ops import reward_kernel
from creste_public_tpu_torch.parallel import spatial
from creste_public_tpu_torch.runtime import benchmark
from creste_public_tpu_torch.runtime.precision import cast_module
from creste_public_tpu_torch.utils.device import resolve_device


class InferenceGraph(nn.Module):
    """The deployment graph as a module: ``forward(rgbd, p2p)`` -> the
    TerrainNet maps plus ``traversability_preds`` [B, 64, 128, 1] (f32),
    ``traversability_preds_full`` and ``input_view``. Unfused it is
    ``MaxEntIRL.forward``; fused, the reward head's folded tensors are
    buffers of this module (``folded_<i>``, ``reward_kernel.
    head_tensors``' order), folded once from the model's head at build."""

    def __init__(self, model: MaxEntIRL, fused_reward: bool):
        super().__init__()
        self.model = model
        self.fused_reward = fused_reward
        rc = model.traversability_head.reward_cfg
        self.input_keys = list(rc["input_keys"])
        self.ds = int(rc["ds"])
        self.prefix = rc["output_prefix"][0]
        tensors = (reward_kernel.head_tensors(reward_kernel.fold_msfcn_params(
            model.traversability_head.r)) if fused_reward else [])
        for i, t in enumerate(tensors):
            self.register_buffer(f"folded_{i}", t)
        self.n_folded = len(tensors)

    def head_tensors(self) -> list[torch.Tensor]:
        """The fused head's folded tensors, on the graph's device."""
        return [getattr(self, f"folded_{i}") for i in range(self.n_folded)]

    def forward(self, rgbd: torch.Tensor, p2p: torch.Tensor
                ) -> dict[str, torch.Tensor]:
        if not self.fused_reward:
            return self.model(rgbd, p2p)
        outputs = dict(self.model.backbone(rgbd, p2p))
        iv = build_input_view(outputs, self.input_keys, self.ds)
        r = torch.ops.creste.msfcn_head(iv.contiguous(), self.head_tensors())
        Ho, Wo = outputs[self.input_keys[0]].shape[1:3]
        outputs.update({self.prefix: r,
                        f"{self.prefix}_full": full_reward_map(r, Ho, Wo),
                        "input_view": iv})
        return outputs


def build_inference_graph(
    cfg: Any, state: Mapping[str, torch.Tensor], device: str = "cuda",
    fused_reward: bool = True, fold_bn: bool = False,
    compute_dtype: str | None = None,
) -> InferenceGraph:
    """The ``InferenceGraph`` of a MaxEntIRL config (``solve_mdp`` forced
    off) with ``state`` (a MaxEntIRL state_dict, loaded strictly) on
    ``device``, in eval mode. ``compute_dtype`` ("bfloat16"; or the
    config's own) casts the weights as ``precision.cast_state`` does (a
    state cast already loads unchanged) and runs the bf16 stream;
    ``fold_bn`` folds every BatchNorm of the graph. The fused head folds
    its BatchNorms in f32 from its (possibly bf16-rounded) weights."""
    dev = resolve_device(device)
    cfg = dict(cfg.to_dict() if hasattr(cfg, "to_dict") else cfg)
    cfg["solve_mdp"] = False
    if compute_dtype:
        cfg["compute_dtype"] = compute_dtype
    model = MaxEntIRL(cfg)
    dt = stream_dtype(cfg)
    if dt is not None:
        cast_module(model, dt)
    model.load_state_dict(state, strict=True)
    if fold_bn:
        fold_batch_norms(model, dt or torch.float32)
    return InferenceGraph(model, fused_reward).to(dev).eval()


def build_inference_fn(
    cfg: Any, state: Mapping[str, torch.Tensor], device: str = "cuda",
    fused_reward: bool = True, fold_bn: bool = False,
    compute_dtype: str | None = None,
) -> Callable[[Any, Any], dict[str, torch.Tensor]]:
    """``fn(rgbd, p2p) -> outputs`` on ``device`` (arrays or tensors in,
    f32; no autograd) over ``build_inference_graph``'s graph, which
    ``fn.graph`` holds. ``fused_reward`` defaults to the kernel's graph,
    the port's deployment path."""
    graph = build_inference_graph(cfg, state, device, fused_reward, fold_bn,
                                  compute_dtype)
    dev = next(graph.parameters()).device

    @torch.no_grad()
    def fn(rgbd, p2p) -> dict[str, torch.Tensor]:
        return graph(torch.as_tensor(rgbd, dtype=torch.float32, device=dev),
                     torch.as_tensor(p2p, dtype=torch.float32, device=dev))

    fn.graph = graph
    return fn


def build_spatial_inference_fn(
    model: MaxEntIRL | InferenceGraph, mesh: spatial.SpatialMesh,
    fused_reward: bool = True, output_keys: Sequence[str] | None = None,
    device: str = "cuda",
) -> Callable[[Any, Any], dict[str, torch.Tensor]]:
    """``fn(rgbd, p2p) -> outputs``: the deployment graph of ``model`` (a
    MaxEntIRL with its weights, or an ``InferenceGraph``, run in eval
    without the MDP solve) with one frame's width split across the ranks
    of ``mesh`` (``parallel.spatial.make_spatial_mesh``), the JAX
    package's ``jit(..., in_shardings=spatial_inference_shardings(mesh))``.
    Every rank calls ``fn`` with the whole frame (f32 rgbd
    [B, N, H, W, 4] and p2p [B, N, 4, 4], arrays or tensors) and keeps its
    columns of rgbd (``spatial_inference_shardings``); the weights and p2p
    are replicated. It returns, on every rank, ``InferenceGraph``'s
    outputs in the one-rank layout (``output_keys`` only, when given:
    the others are not gathered). With ``fused_reward`` each rank runs the
    folded reward head once per frame on its columns of the input view
    plus a halo (``creste::msfcn_head``: the kernel on the card);
    ``fn.head_columns(width)`` gives each rank's columns of it. The model
    is moved to ``device`` (on CUDA, this process's current card)."""
    if isinstance(model, InferenceGraph):
        model = model.model
    if mesh.rank < 0:
        raise ValueError("this rank is not a member of the spatial mesh")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    model.to(dev).eval()
    tensors = (reward_kernel.head_tensors(reward_kernel.fold_msfcn_params(
        model.traversability_head.r)) if fused_reward else None)

    @torch.no_grad()
    def fn(rgbd, p2p) -> dict[str, torch.Tensor]:
        rgbd = torch.as_tensor(rgbd, dtype=torch.float32, device=dev)
        p2p = torch.as_tensor(p2p, dtype=torch.float32, device=dev)
        width = rgbd.shape[3]
        _, cols, rep = spatial.spatial_inference_shardings(mesh, width)
        outputs = spatial.deployment_graph(
            model, cols.shard(rgbd, mesh).contiguous(), rep.shard(p2p, mesh),
            width, mesh, tensors)
        return spatial.gather_outputs(outputs, mesh, output_keys)

    fn.head_columns = lambda width: spatial.head_strip_columns(width, mesh)
    return fn


class _Selected(nn.Module):
    """A graph whose outputs are cut to ``keys``, in the order of their
    names (the manifest's order, and JAX's flat order)."""

    def __init__(self, graph: nn.Module, keys: Sequence[str] | None):
        super().__init__()
        self.inner = graph  # not "graph": an exported module's own attribute
        self.keys = list(keys) if keys else None

    def forward(self, rgbd: torch.Tensor, p2p: torch.Tensor
                ) -> dict[str, torch.Tensor]:
        out = self.inner(rgbd, p2p)
        return {k: out[k] for k in sorted(self.keys or out)}


def export_inference_graph(
    graph: nn.Module, rgbd: Any, p2p: Any, out_path: str | None = None,
    output_keys: Sequence[str] | None = None,
) -> torch.export.ExportedProgram:
    """``torch.export`` of ``graph`` (an ``InferenceGraph``) at the shapes
    of ``rgbd`` and ``p2p``, on the graph's device, optionally cut to
    ``output_keys``; saved to ``out_path`` with ``torch.export.save`` when
    given. The program holds the weights; the fused head stays one call of
    ``creste::msfcn_head``."""
    dev = next(graph.parameters()).device
    args = (torch.as_tensor(rgbd, dtype=torch.float32, device=dev),
            torch.as_tensor(p2p, dtype=torch.float32, device=dev))
    with torch.no_grad():
        program = torch.export.export(_Selected(graph, output_keys).eval(),
                                      args, strict=False)
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)),
                    exist_ok=True)
        torch.export.save(program, out_path)
    return program


def load_exported(path: str) -> torch.export.ExportedProgram:
    """A program saved by ``export_inference_graph``; ``.module()`` runs
    it. The operator it calls is registered by this module's import of
    ``ops.reward_kernel``."""
    return torch.export.load(path)


_DTYPE_TOKENS = {
    "float32": "f32", "bfloat16": "bf16", "float16": "f16",
    "int32": "s32", "int64": "s64", "uint8": "u8", "bool": "pred",
}
PROGRAM_FILE = "program.pt2"
MANIFEST_FILE = "manifest.txt"
HOST_PACKAGE_FILE = "host.pt2"


def _spec_line(kind: str, name: str, t: torch.Tensor) -> str:
    dtype = str(t.dtype).removeprefix("torch.")
    dims = ",".join(str(d) for d in t.shape)
    return f"{kind} {name} {_DTYPE_TOKENS.get(dtype, dtype)} {dims}"


def openmp_cxx() -> str:
    """A C++ compiler that links an OpenMP shared object: AOTInductor
    compiles and links its wrapper with ``-fopenmp`` (and ``-lgomp``),
    which a GCC without ``libgomp.spec`` refuses. ``$CXX`` (inductor's own
    choice) first, then ``g++``, ``c++``, ``/usr/bin/g++``, ``clang++``;
    raises when none links."""
    import shutil
    import subprocess
    import tempfile

    tried = []
    for cxx in dict.fromkeys(c for c in (os.environ.get("CXX"), "g++", "c++",
                                         "/usr/bin/g++", "clang++") if c):
        path = shutil.which(cxx)
        if path is None:
            continue
        with tempfile.TemporaryDirectory() as tmp:
            src = os.path.join(tmp, "omp.cpp")
            with open(src, "w") as f:
                f.write("#include <omp.h>\nint threads() { return "
                        "omp_get_max_threads(); }\n")
            r = subprocess.run([path, "-fopenmp", "-shared", "-fPIC", src,
                                "-o", os.path.join(tmp, "omp.so"), "-lgomp"],
                               capture_output=True, text=True)
        if r.returncode == 0:
            return path
        tried.append(f"{path}: {r.stderr.strip()[-300:]}")
    raise RuntimeError("no C++ compiler links -fopenmp, which AOTInductor's "
                       "package needs:\n" + "\n".join(tried))


def package_for_host(out_dir: str) -> dict:
    """AOT-compile the native artifact's program (``out_dir/program.pt2``,
    ``torch._inductor.aoti_compile_and_package``) into
    ``out_dir/host.pt2`` for the device its weights are on, and end the
    manifest with ``package host.pt2 <device type>``: the package the
    libtorch host loads, the weights inside, the fused head one call of
    ``creste::msfcn_head`` by name, compiled by ``openmp_cxx()``. Returns
    its bytes and the compile's seconds."""
    import torch._inductor.config

    program = load_exported(os.path.join(out_dir, PROGRAM_FILE))
    dev = next(iter(program.state_dict.values())).device
    path = os.path.join(out_dir, HOST_PACKAGE_FILE)
    t0 = time.perf_counter()
    # NCHW convolutions, as the eager graph runs them: inductor's layout
    # optimization moves them to channels_last, where cuDNN's f32 kernels
    # are slower on the H100 (the production frame 28.4 ms with it, 21.3
    # without; chip_smoke phase 44)
    with torch._inductor.config.patch({"cpp.cxx": (openmp_cxx(),),
                                       "layout_optimization": False}):
        torch._inductor.aoti_compile_and_package(program, package_path=path)
    seconds = time.perf_counter() - t0
    manifest = os.path.join(out_dir, MANIFEST_FILE)
    with open(manifest) as f:
        lines = [ln for ln in f.read().splitlines()
                 if not ln.startswith("package ")]
    lines.append(f"package {HOST_PACKAGE_FILE} {dev.type}")
    with open(manifest, "w") as f:
        f.write("\n".join(lines) + "\n")
    return {"package_bytes": os.path.getsize(path), "package_s": seconds,
            "manifest_lines": len(lines)}


def export_native_artifacts(
    cfg: Any, state: Mapping[str, torch.Tensor], rgbd: Any, p2p: Any,
    out_dir: str, fused_reward: bool = False,
    output_keys: Sequence[str] | None = None, fold_bn: bool = False,
    compute_dtype: str | None = None, device: str = "cuda",
    package: bool = False,
) -> dict:
    """Write the deployment artifact: ``out_dir/program.pt2``, the exported
    graph with its weights inside (calling convention ``(rgbd, p2p) ->
    outputs``), and ``out_dir/manifest.txt``: ``format torch_export``, then
    one line per input (``rgbd``, ``p2p``) and per output, sorted by name,
    ``input|output <name> <dtype token> <dims>`` as the JAX package writes
    them. The program is run once on the inputs (its dry run) for the
    outputs' shapes. ``output_keys`` keeps only those outputs. With
    ``package`` the program is also AOT-compiled for the host
    (``package_for_host``)."""
    graph = build_inference_graph(cfg, state, device, fused_reward, fold_bn,
                                  compute_dtype)
    path = os.path.join(out_dir, PROGRAM_FILE)
    program = export_inference_graph(graph, rgbd, p2p, path, output_keys)
    dev = next(graph.parameters()).device
    args = [torch.as_tensor(a, dtype=torch.float32, device=dev)
            for a in (rgbd, p2p)]
    with torch.no_grad():
        out = program.module()(*args)
    lines = ["format torch_export"]
    lines += [_spec_line("input", n, a) for n, a in zip(("rgbd", "p2p"),
                                                           args)]
    lines += [_spec_line("output", k, out[k]) for k in sorted(out)]
    with open(os.path.join(out_dir, MANIFEST_FILE), "w") as f:
        f.write("\n".join(lines) + "\n")
    info = {"program_bytes": os.path.getsize(path), "num_inputs": 2,
            "num_outputs": len(out), "manifest_lines": len(lines)}
    if package:
        info.update(package_for_host(out_dir))
    return info


class InferenceEngine:
    """Steady-state serving: the graph and its weights built once on the
    device; ``step(rgbd, p2p)`` copies one frame in and returns the outputs
    on the device. ``latency_stats`` times single frames (CUDA events on
    the card, a host clock on the CPU)."""

    def __init__(self, cfg: Any, state: Mapping[str, torch.Tensor],
                 device: str = "cuda", fused_reward: bool = True,
                 fold_bn: bool = False, compute_dtype: str | None = None):
        self.fn = build_inference_fn(cfg, state, device, fused_reward,
                                     fold_bn, compute_dtype)
        self.graph = self.fn.graph
        self.device = next(self.graph.parameters()).device

    def step(self, rgbd, p2p) -> dict[str, torch.Tensor]:
        return self.fn(rgbd, p2p)

    def warmup(self, rgbd, p2p) -> None:
        self.step(rgbd, p2p)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def latency_stats(self, rgbd, p2p, iters: int = 50) -> dict[str, Any]:
        """p50 / p95 single-frame latency in ms and the Hz of the p50, over
        ``iters`` frames after a warm-up, each timed call on a fresh
        device-resident input (``benchmark.frame_times_ms``); ``clock``
        says what timed them."""
        self.warmup(rgbd, p2p)
        if self.device.type == "cuda":
            times = benchmark.frame_times_ms(self.fn, rgbd, p2p, iters,
                                             self.device)
            clock = "cuda_events"
        else:
            times = []
            for _ in range(iters):
                t0 = time.perf_counter()
                self.step(rgbd, p2p)
                times.append((time.perf_counter() - t0) * 1e3)
            clock = "host"
        p50 = float(np.percentile(times, 50))
        return {"p50_ms": p50, "p95_ms": float(np.percentile(times, 95)),
                "hz": 1e3 / p50, "clock": clock}
