"""One command from a raw sensor tree to a served frame: raw -> preprocess
-> annotate -> train (three stages) -> export -> parity -> serve.

The counterpart of ``scripts/e2e_pipeline.py``. The reference documents
this as a multi-day recipe spread over nine preprocessing CLIs, a Flask
annotation session, three Hydra trainings with cross-stage checkpoint
surgery and a TorchScript trace (docs/TRAINING.md; README.md:78-108). This
module runs the same chain through the port's own entry points, not
library shortcuts, over a synthesized raw sensor tree:

  raw tree        ``data.raw_synthetic`` (sensors only)
  preprocessing   the eight ``preprocessing.<name>.main(argv)`` entry points
                  (depth, 2-D SAM, DINO features, BEV SAM maps, elevation,
                  traversability frames, splits, downsampled depth copies)
  annotation      ``annotation.app`` driven over HTTP
                  (/load -> rank -> /save counterfactual pickles)
  training        ``cli.launch`` of distillation -> ssc_sam ->
                  traversability with weights_path / load_setting surgery
  export          ``runtime.compile --fused`` (``torch.export`` program and
                  the native artifact, the reward head as
                  ``creste::msfcn_head``)
  parity          the reloaded program against a direct
                  ``MaxEntIRL(solve_mdp=False)`` forward on a real
                  preprocessed sample of the tree
  serve           ``runtime.serve.build_server`` on a free local port: one
                  POST /infer of that sample against the direct forward
  native serve    the artifact AOT-compiled for the libtorch host
                  (``export.package_for_host``) and served by it, no Python
                  in its process (``runtime.native_serve``: ``--in`` that
                  sample, ``--dump`` its outputs) against the direct forward

The JAX script's last leg runs its C++ PJRT host (``native/creste_serve``)
over its artifact; the port's runs ``csrc/serve_host.cpp``, built from the
checkout's sources at first use (``--no-serve`` skips both serve legs, as
the JAX script's does). ``--pjrt-plugin`` has no counterpart.

Each step is a function of a tree's root (the parity legs of the direct
forward's result), so a caller can run the steps on a tree it already
has, with the production models (``tiny=False``) as chip_smoke.py's
phases 38-40 do. The command trains the tiny presets with a cut trunk
(``model=*/tiny``, ``stage_repeats=1``), as the JAX script does.

    python -m creste_public_tpu_torch.e2e_pipeline --work D [--frames 24] \\
        [--grid 32] [--map_range 1.6] [--horizon 10] [--tol 2e-4] \\
        [--no-serve] [--fresh] [--device cuda|cpu]

It runs on the card unless ``--device cpu``, and refuses to start without
CUDA otherwise.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import os
import shutil
import threading
import time
import urllib.request
from http.server import HTTPServer
from typing import Any, Sequence

import numpy as np
import torch

from creste_public_tpu_torch.utils.device import resolve_device

STAGES = ("distillation", "ssc", "traversability")
# (cli.launch root, tiny model group, the trunk's stage_repeats path)
STAGE_ROOTS = {
    "distillation": ("distillation", "distillation/tiny",
                     "vision_backbone.effnet_cfgs"),
    "ssc": ("ssc_sam", "ssc_sam/tiny", "vision_backbone.effnet_cfgs"),
    "traversability": ("traversability", "traversability/tiny",
                       "vision_backbone.vision_backbone.effnet_cfgs"),
}
LOAD_SETTINGS = {"ssc": "strict", "traversability": "strict_freeze"}
BATCH_SIZE = 2
REWARD_KEY = "traversability_preds"
NUM_CANDIDATES = 4
N_COUNTERFACTUALS = 4
FOV_ANGLES = (70, 70, 1, 200)


def feature_hw(img_hw: tuple[int, int],
               image_size: tuple[int, int] | None) -> tuple[int, int]:
    """The DINO label's [h, w]: the frame the reader gives, divided by 4
    (the width rounded up, as the stride-4 features of a 612-wide frame)."""
    h, w = image_size or img_hw
    return h // 4, -(-w // 4)


def preprocess_steps(root: str, seq: str, grid: int, map_range: float,
                     fdn_hw: tuple[int, int], fdn_dim: int, horizon: int,
                     device: str = "cuda", workers: int | None = None
                     ) -> list[tuple[str, list[str]]]:
    """(entry point, argv) of the eight preprocessing entry points in
    scripts/e2e_pipeline.py::preprocess's order and arguments, each given
    ``--device``; ``workers`` caps the map builders' process pools (the
    JAX script leaves them at their defaults)."""
    g, r = str(grid), str(map_range)
    depth_dir = os.path.join(root, "depth_5_LA_all")
    pool = ["--workers", str(workers)] if workers else []
    steps = [
        ("build_dense_depth", ["--root", root, "--seqs", seq, "--scans", "5",
                               "--proc", "LA", "--workers", "2"]),
        ("downsample_frames", ["--in_dir", depth_dir,
                               "--out_dir", depth_dir + "_ds4",
                               "--factor", "4"]),
        ("create_sam_dataset", ["--root", root, "--seqs", seq,
                                "--mode", "static"]),
        ("create_sam_dataset", ["--root", root, "--seqs", seq,
                                "--mode", "dynamic"]),
        ("create_pe_dataset", ["--root", root, "--seqs", seq, "--pca_dim",
                               str(fdn_dim), "--out_hw", *map(str, fdn_hw)]),
        ("build_sam_map", ["--root", root, "--seqs", seq, "--mode", "static",
                           "--grid", g, "--map_range", r, "--ds", "4",
                           "--horizon", "3", *pool]),
        ("build_sam_map", ["--root", root, "--seqs", seq, "--mode",
                           "dynamic", "--grid", g, "--map_range", r,
                           "--ds", "4", *pool]),
        ("build_feature_map", ["--root", root, "--seqs", seq, "--tasks",
                               "elevation", "--grid", g, "--map_range", r,
                               "--scans", "5", "--window", "10", *pool]),
        ("create_traversability_dataset", ["--root", root, "--seqs", seq,
                                           "--num_frames", str(horizon),
                                           "--dist_thresh", "1.0"]),
        ("build_splits", ["--root", root, "--seqs", seq, "--horizon",
                          str(horizon), "--min_distance", "0.5"]),
    ]
    return [(name, [*args, "--device", str(device)]) for name, args in steps]


def preprocess(root: str, seq: str, grid: int, map_range: float,
               fdn_hw: tuple[int, int], fdn_dim: int, horizon: int,
               device: str = "cuda", workers: int | None = None
               ) -> list[tuple[str, float]]:
    """Runs ``preprocess_steps`` in-process through each entry point's
    argparse; returns (entry point, wall s) per step."""
    walls = []
    for name, args in preprocess_steps(root, seq, grid, map_range, fdn_hw,
                                       fdn_dim, horizon, device, workers):
        main = importlib.import_module(
            f"creste_public_tpu_torch.preprocessing.{name}").main
        print(f"[e2e] {name} {' '.join(args)}", flush=True)
        t0 = time.perf_counter()
        main(args)
        walls.append((name, time.perf_counter() - t0))
    return walls


@contextlib.contextmanager
def serving(server: HTTPServer):
    """``server`` on a daemon thread for the block's duration; shut down and
    closed after it, whatever the block raised."""
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        yield server.server_address[1]
    finally:
        server.shutdown()
        server.server_close()
        t.join()


def annotate(root: str, seq: str, grid: int, map_range: float,
             horizon: int, frames: Sequence[int],
             num_candidates: int = NUM_CANDIDATES) -> int:
    """Drives the annotation app over HTTP as the browser frontend does:
    /load each frame, rank the trajectories in reverse order of
    presentation, /save. Returns the frames saved; a failed request
    raises."""
    from creste_public_tpu_torch.annotation.app import (
        AnnotationBackend,
        make_handler,
    )

    be = AnnotationBackend(root, grid=grid, map_range=map_range,
                           horizon=horizon, num_candidates=num_candidates)
    n = 0
    with serving(HTTPServer(("127.0.0.1", 0), make_handler(be))) as port:
        for fr in frames:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/load?seq={seq}&frame={fr}"
            ) as r:
                payload = json.loads(r.read())
            k = len(payload["trajectories"])
            body = json.dumps({
                "seq": seq, "frame": fr,
                "trajectories": payload["trajectories"],
                # drag order: reverse of presentation (a real ranking)
                "order": list(range(k))[::-1],
            }).encode()
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/save", data=body,
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req) as r:
                r.read()
            n += 1
    print(f"[e2e] annotated {n} frames -> counterfactuals/", flush=True)
    return n


def dataset_overrides(root: str, grid: int, map_range: float, horizon: int,
                      image_size: tuple[int, int] | None = None
                      ) -> list[str]:
    """The ``dataset=coda`` overrides every stage trains with."""
    out = ["dataset=coda", f"dataset.root={root}", f"dataset.grid={grid}",
           f"dataset.map_range={map_range}", f"dataset.horizon={horizon}",
           "dataset.ds=4", f"dataset.n_counterfactuals={N_COUNTERFACTUALS}",
           "dataset.fov_angles=[{}, {}, {}, {}]".format(*FOV_ANGLES)]
    if image_size:
        out.append("dataset.image_size=[{}, {}]".format(*image_size))
    return out


def stage_argv(stage: str, root: str, work: str, grid: int,
               map_range: float, horizon: int, device: str, tiny: bool,
               image_size: tuple[int, int] | None = None
               ) -> tuple[str, list[str], str]:
    """(cli.launch root, argv, checkpoint directory) of one stage; each
    stage after the first grafts the previous stage's checkpoint."""
    launch_root, tiny_model, trunk = STAGE_ROOTS[stage]
    ckpt = os.path.join(work, f"ckpt_{stage}")
    argv = [*dataset_overrides(root, grid, map_range, horizon, image_size),
            "trainer=smoke", "trainer.num_workers=2",
            f"trainer.device={device}", f"model.batch_size={BATCH_SIZE}",
            f"trainer.ckpt_dir={ckpt}"]
    if tiny:
        # cap the EffNet trunk like presets.tiny_* so that compile --tiny
        # takes the stage-3 checkpoint as it is
        argv += [f"model={tiny_model}", f"model.{trunk}.stage_repeats=1"]
    i = STAGES.index(stage)
    if i:
        argv += [f"model.weights_path="
                 f"{os.path.join(work, f'ckpt_{STAGES[i - 1]}')}",
                 f"model.load_setting={LOAD_SETTINGS[stage]}"]
    return launch_root, argv, ckpt


def train_stages(root: str, work: str, grid: int, map_range: float,
                 horizon: int, device: str = "cuda", tiny: bool = True,
                 image_size: tuple[int, int] | None = None
                 ) -> dict[str, dict]:
    """The three stages through ``cli.launch`` on the tree's labels and
    counterfactuals; per stage its checkpoint directory, steps, wall s and
    (on the card) peak GiB."""
    from creste_public_tpu_torch import cli

    dev = resolve_device(device)
    out = {}
    for stage in STAGES:
        launch_root, argv, ckpt = stage_argv(
            stage, root, work, grid, map_range, horizon, dev.type, tiny,
            image_size)
        print(f"[e2e] stage {STAGES.index(stage) + 1}: {launch_root}",
              flush=True)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state = cli.launch(launch_root, argv)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        out[stage] = {
            "ckpt": ckpt, "steps": int(state.step),
            "seconds": time.perf_counter() - t0,
            "peak_gib": (torch.cuda.max_memory_allocated() / 2 ** 30
                         if dev.type == "cuda" else None)}
    return out


def reader_config(root: str, grid: int, map_range: float, horizon: int,
                  image_size: tuple[int, int] | None = None) -> dict:
    """The CodaDataset config of the parity sample (the training overrides'
    reader)."""
    cfg = {"root": root, "grid": grid, "map_range": map_range, "ds": 4,
           "horizon": horizon, "fov_angles": FOV_ANGLES,
           "n_counterfactuals": N_COUNTERFACTUALS}
    if image_size:
        cfg["image_size"] = list(image_size)
    return cfg


def direct_forward(root: str, ckpt_dir: str, grid: int, map_range: float,
                   horizon: int, device: str = "cuda", tiny: bool = True,
                   image_size: tuple[int, int] | None = None) -> dict:
    """Sample 0 of the tree's train split through ``MaxEntIRL(solve_mdp=
    False)`` with the stage-3 checkpoint's weights, in eval mode: the
    checkpoint's step directory, the sample's RGBD [1, 1, H, W, 4] and p2p
    [1, 1, 4, 4], and the forward's outputs and reward, on ``device``
    with deterministic algorithms (the parity legs compare against it)."""
    from creste_public_tpu_torch.data.coda_dataset import CodaDataset
    from creste_public_tpu_torch.models.lfd import MaxEntIRL
    from creste_public_tpu_torch.runtime.compile import (
        deployment_config,
        deployment_state,
    )
    from creste_public_tpu_torch.training.checkpoint import latest_checkpoint

    dev = resolve_device(device)
    step = latest_checkpoint(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    s = CodaDataset(reader_config(root, grid, map_range, horizon, image_size),
                    split="train", device=dev)[0]
    # sample contract: image [V, H, W, 4] RGB/255 + depth-mm channel,
    # p2p [V, 4, 4]: the deployment graph's input layout
    rgbd = s["image"][None].astype(np.float32)
    p2p = s["p2p"][None].astype(np.float32)
    cfg = deployment_config(tiny)
    model = MaxEntIRL(cfg)
    model.load_state_dict(deployment_state(cfg, step), strict=True)
    model = model.to(dev).eval()
    with deterministic(), torch.no_grad():
        out = model(torch.from_numpy(rgbd).to(dev),
                    torch.from_numpy(p2p).to(dev))
    outputs = {k: v.float().cpu().numpy() for k, v in out.items()
               if isinstance(v, torch.Tensor)}
    return {"step": step, "device": dev.type, "tiny": tiny, "rgbd": rgbd,
            "p2p": p2p, "reward": outputs[REWARD_KEY], "outputs": outputs}


def worst_output_gap(got: dict, want: dict) -> tuple[str, float]:
    """(key, max|d| / max(1, max|ref|)) of the worst of the outputs that
    ``got`` and ``want`` share."""
    worst = ("", 0.0)
    for k in sorted(set(got) & set(want)):
        a = np.asarray(got[k].float().cpu() if torch.is_tensor(got[k])
                       else got[k], np.float32)
        b = np.asarray(want[k], np.float32)
        if a.shape != b.shape:
            raise AssertionError(f"{k}: shape {a.shape} != {b.shape}")
        gap = float(np.max(np.abs(a - b), initial=0.0)) / max(
            1.0, float(np.max(np.abs(b), initial=0.0)))
        if gap >= worst[1]:
            worst = (k, gap)
    return worst


def head_launches() -> int:
    """The reward-head kernel's launches so far in this process (its
    wrapper's count; the CPU's plain version launches none)."""
    from creste_public_tpu_torch.ops.reward_kernel import msfcn_head_cuda

    return msfcn_head_cuda.launches


@contextlib.contextmanager
def deterministic():
    """Deterministic algorithms for the block (the splat's ``index_add_``
    is atomic on the card), restored after it."""
    was = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn)


def check_reward(name: str, got: np.ndarray, direct: dict,
                 tol: float) -> float:
    """max|got - direct reward|, raising above ``tol``."""
    want = direct["reward"]
    if got.shape != want.shape:
        raise AssertionError(f"{name}: reward {got.shape} != {want.shape}")
    dev_max = float(np.max(np.abs(got - want)))
    if not dev_max <= tol:
        raise AssertionError(f"{name} {dev_max} > {tol}")
    return dev_max


def export_and_check(work: str, direct: dict, tol: float) -> dict:
    """Exports the fused deployment graph from ``direct``'s stage-3
    checkpoint through ``runtime.compile``, reloads the program and holds
    its reward on ``direct``'s sample to the direct forward, max|d| <=
    ``tol``, and every other output it shares with the direct forward to
    ``tol`` of its scale; the export and reload seconds, the reward-head
    launches of the reloaded program's frame, and that frame's input view
    and reward."""
    from creste_public_tpu_torch.runtime import compile as compile_cli
    from creste_public_tpu_torch.runtime.export import load_exported

    dev = torch.device(direct["device"])
    out = os.path.join(work, "creste_rgbd_export.pt2")
    native_dir = os.path.join(work, "native_artifact")
    with deterministic():
        t0 = time.perf_counter()
        compile_cli.main(["--ckpt", direct["step"], "--out", out, "--fused",
                          "--native-dir", native_dir, "--device", dev.type]
                         + (["--tiny"] if direct["tiny"] else []))
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        program = load_exported(out).module()
        reload_s = time.perf_counter() - t0
        before = head_launches()
        with torch.no_grad():
            served = program(torch.from_numpy(direct["rgbd"]).to(dev),
                             torch.from_numpy(direct["p2p"]).to(dev))
        launches = head_launches() - before
    got = served[REWARD_KEY].float().cpu().numpy()
    dev_max = check_reward("export parity", got, direct, tol)
    # every other map the program returns, relative to its scale
    key, gap = worst_output_gap(served, direct["outputs"])
    if not gap <= tol:
        raise AssertionError(f"export parity: {key} {gap} > {tol}")
    print(f"[e2e] export parity on a real sample: max|d| = {dev_max:.2e}",
          flush=True)
    return {"export": out, "native_dir": native_dir, "parity_dev": dev_max,
            "outputs_dev": (key, gap), "export_s": export_s,
            "reload_s": reload_s, "reward_shape": list(got.shape),
            "head_launches": launches,
            "input_view": served["input_view"].float().cpu().numpy(),
            "reward": got}


def serve_check(direct: dict, tol: float) -> dict:
    """``runtime.serve`` (fused) from ``direct``'s stage-3 checkpoint on a
    free local port: GET /healthz, then ``direct``'s sample POSTed to
    /infer, its reply equal to the server's engine on the same frame bit
    for bit and to the direct forward to ``tol`` (and the engine's other
    maps on that frame to ``tol`` of their scale); the request's wall ms
    and, on the card, its CUDA-event ms (deterministic algorithms on), the
    warm server's Hz, and the reward-head launches the request made."""
    from creste_public_tpu_torch.runtime.serve import build_server

    dev = torch.device(direct["device"])
    rgbd, p2p = direct["rgbd"], direct["p2p"]
    # the warm-up and the server's Hz as deployed; the compared request
    # with deterministic algorithms
    server, engine, stats = build_server(
        ["--ckpt", direct["step"], "--fused", "--host", "127.0.0.1",
         "--port", "0", "--device", dev.type]
        + (["--tiny"] if direct["tiny"] else []))
    with deterministic():
        with serving(server) as port:
            url = f"http://127.0.0.1:{port}"
            with urllib.request.urlopen(f"{url}/healthz") as r:
                health = json.loads(r.read())
            if health.get("status") != "ok":
                raise AssertionError(f"serve: /healthz answered {health}")
            req = urllib.request.Request(
                f"{url}/infer", data=rgbd.tobytes(),
                headers={"X-P2P": json.dumps(p2p.reshape(-1).tolist())})
            before = head_launches()
            events = ([torch.cuda.Event(enable_timing=True)
                       for _ in range(2)] if dev.type == "cuda" else None)
            if events:
                events[0].record()
            t0 = time.perf_counter()
            with urllib.request.urlopen(req) as r:
                body, shape = r.read(), json.loads(r.headers["X-Shape"])
            round_trip_ms = 1e3 * (time.perf_counter() - t0)
            if events:
                events[1].record()
                torch.cuda.synchronize()
            launches = head_launches() - before
        reply = np.frombuffer(body, np.float32).reshape(shape)
        step = engine.step(rgbd, p2p)
    own = step[REWARD_KEY].float().cpu().numpy()
    if not np.array_equal(reply, own):
        raise AssertionError(
            f"serve: the reply differs from the engine's step by "
            f"{float(np.max(np.abs(reply - own))):.3e}")
    dev_max = check_reward("serve parity", reply, direct, tol)
    # the engine's other maps on the same frame, relative to their scale
    key, gap = worst_output_gap(step, direct["outputs"])
    if not gap <= tol:
        raise AssertionError(f"serve parity: {key} {gap} > {tol}")
    print(f"[e2e] served a real sample: max|d| = {dev_max:.2e} from the "
          f"direct forward, equal to the engine's step; {stats['hz']:.1f} "
          "Hz warm", flush=True)
    return {"serve_dev": dev_max, "outputs_dev": (key, gap),
            "serve_hz": stats["hz"], "round_trip_ms": round_trip_ms,
            "served_ms": (events[0].elapsed_time(events[1]) if events
                          else None),
            "reply_shape": list(shape), "head_launches": launches}


def native_check(work: str, direct: dict, native_dir: str,
                 tol: float) -> dict:
    """The native leg: the artifact of ``export_and_check`` in
    ``native_dir`` AOT-compiled for the libtorch host
    (``export.package_for_host``), then the host run over it on
    ``direct``'s sample (``--in``; 3 timed frames, no streaming)
    with ``--dump``: its reward within ``tol`` of the direct forward's and
    every other output within ``tol`` of its scale; the package's compile
    seconds, the host's ms per frame and its reward-head launches per
    frame served."""
    from creste_public_tpu_torch.runtime import native_serve
    from creste_public_tpu_torch.runtime.export import package_for_host

    dev = direct["device"]
    packaged = package_for_host(native_dir)
    dump = os.path.join(work, "native_dump")
    inputs = native_serve.write_inputs(
        os.path.join(work, "native_in"),
        {"rgbd": direct["rgbd"], "p2p": direct["p2p"]})
    report = native_serve.run_host(native_dir, dev, iters=3, warmup=1,
                                   distinct=1, pipeline=0, inputs=inputs,
                                   dump=dump)
    served = native_serve.read_dump(dump, native_dir)
    dev_max = check_reward("native serve parity",
                           served[REWARD_KEY].numpy(), direct, tol)
    key, gap = worst_output_gap(served, direct["outputs"])
    if not gap <= tol:
        raise AssertionError(f"native serve parity: {key} {gap} > {tol}")
    print(f"[e2e] the libtorch host served the sample: max|d| = "
          f"{dev_max:.2e} from the direct forward, "
          f"{report['per_frame_ms']:.2f} ms/frame", flush=True)
    return {"native_dev": dev_max, "native_outputs_dev": (key, gap),
            "package_s": packaged["package_s"],
            "native_ms": report["per_frame_ms"],
            "native_head_launches": report["msfcn_head_launches"],
            "native_frames": report["frames_run"]}


def run_pipeline(work: str, frames: int = 24, img_hw=(64, 80),
                 grid: int = 32, map_range: float = 1.6, horizon: int = 10,
                 tol: float = 2e-4, serve: bool = True,
                 device: str = "cuda", workers: int | None = None
                 ) -> dict[str, Any]:
    """The whole chain over a fresh raw tree under ``work``, with the tiny
    models (the frames read at their native size)."""
    from creste_public_tpu_torch.data.raw_synthetic import write_raw_coda_tree

    dev = resolve_device(device).type
    os.makedirs(work, exist_ok=True)
    root = os.path.join(work, "data")
    seq = "0"
    manifest = write_raw_coda_tree(
        root, seq=seq, n_frames=frames, img_hw=tuple(img_hw), speed=0.22,
        curve=0.015, max_range=2 * map_range)
    print(f"[e2e] raw tree: {manifest}", flush=True)
    result: dict[str, Any] = {"root": root}
    result["preprocess_s"] = preprocess(
        root, seq, grid, map_range, feature_hw(img_hw, None), 16, horizon,
        dev, workers)
    result["annotated"] = annotate(
        root, seq, grid, map_range, horizon,
        frames=list(range(0, max(1, frames - horizon), 4)))
    stages = train_stages(root, work, grid, map_range, horizon, dev)
    result["stages"] = stages
    direct = direct_forward(root, stages["traversability"]["ckpt"], grid,
                            map_range, horizon, dev)
    result.update(export_and_check(work, direct, tol))
    if serve:  # the Python server, then the libtorch host
        result.update(serve_check(direct, tol))
        result.update(native_check(work, direct, result["native_dir"], tol))
    print("[e2e] PIPELINE COMPLETE", flush=True)
    return result


def main(argv: Sequence[str] | None = None) -> dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--work", default="creste_e2e")
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--grid", type=int, default=32)
    ap.add_argument("--map_range", type=float, default=1.6)
    ap.add_argument("--horizon", type=int, default=10)
    ap.add_argument("--tol", type=float, default=2e-4)
    ap.add_argument("--no-serve", action="store_true")
    ap.add_argument("--fresh", action="store_true", help="wipe --work first")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    if args.fresh and os.path.isdir(args.work):
        shutil.rmtree(args.work)
    result = run_pipeline(
        args.work, frames=args.frames, grid=args.grid,
        map_range=args.map_range, horizon=args.horizon, tol=args.tol,
        serve=not args.no_serve, device=args.device)
    print(json.dumps({k: v for k, v in result.items() if k != "stages"},
                     default=str))
    return result


if __name__ == "__main__":
    main()
