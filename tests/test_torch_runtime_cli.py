"""The port's runtime entry points on the CPU, at the tiny preset:
``runtime.parity_check`` against the JAX package's pure-torch mirror of the
reference (``creste_public_tpu.parity.torch_mirror``, which carries the
reference's key names) as a Lightning checkpoint and as its TorchScript
trace, ``runtime.compile`` with its reload, and ``runtime.serve`` in a
thread answering one ``POST /infer`` and ``GET /healthz``.

The mirror's weights are a seeded flax-shaped tree with jittered
BatchNorms (``tests.test_torch_helpers``) through the JAX package's
``export_torch_style``; the mirror run on the sample gives the reference
outputs, as ``tests/test_parity_check_cli.py`` does for the JAX CLI.
"""
import json
import pickle
import threading
import urllib.request

import numpy as np
import pytest
import torch

from creste_public_tpu.config import presets as jpresets
from creste_public_tpu.models.lfd import MaxEntIRL as JMaxEntIRL
from creste_public_tpu.parity import torch_mirror as tm
from creste_public_tpu.training.torch_import import export_torch_style
from creste_public_tpu_torch.runtime import compile as compile_cli
from creste_public_tpu_torch.runtime import parity_check, serve
from creste_public_tpu_torch.runtime.export import (
    InferenceEngine,
    load_exported,
)
from tests.test_torch_helpers import jax_variables, jitter_bn, seeded_variables
from tests.test_torch_step_helpers import one_torch_thread  # noqa: F401

TOL = 1e-3  # the parity bar of docs/PARITY.md, as the JAX CLI's test holds


@pytest.fixture(scope="module")
def mirror_case(tmp_path_factory):
    """(the mirror, its Lightning checkpoint, its trace, the sample pickle,
    the expected-outputs pickle) in a module temp dir."""
    d = tmp_path_factory.mktemp("parity")
    cfg = jpresets.tiny_traversability_config().to_dict()
    cfg["solve_mdp"] = False
    rgbd, p2p = compile_cli.example_inputs(*compile_cli.image_size(cfg),
                                           depth_mm=3000.0)
    flat = jitter_bn(seeded_variables(JMaxEntIRL(cfg), rgbd, p2p, seed=11))
    mirror = tm.TorchMaxEntIRLReward(cfg)
    tm.load_exported_state_dict(mirror, export_torch_style(
        jax_variables(flat)))
    mirror.eval()
    ckpt = d / "reference.ckpt"
    torch.save({"state_dict": {f"model.{k}": v
                               for k, v in mirror.state_dict().items()}},
               ckpt)
    x = torch.from_numpy(np.ascontiguousarray(
        np.transpose(rgbd, (0, 1, 4, 2, 3))))
    with torch.no_grad():
        tout = mirror(x, torch.from_numpy(p2p))
        traced = torch.jit.trace(mirror, (x, torch.from_numpy(p2p)),
                                 strict=False)
    trace = d / "creste_rgbd_trace.pt"
    torch.jit.save(traced, str(trace))
    sample = d / "sample.pkl"
    with open(sample, "wb") as f:
        pickle.dump({"rgbd": rgbd, "p2p": p2p}, f)
    expected = d / "expected.pkl"
    with open(expected, "wb") as f:
        pickle.dump({"traversability_preds":
                     tout["traversability_preds"].numpy()}, f)
    return ckpt, trace, sample, expected


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_parity_check_with_reference_checkpoint(mirror_case, capsys, fused):
    """The Lightning-style checkpoint of the mirror imports with no
    unmatched, dropped or missing key and the port's reward meets the mirror's to <= 1e-3
    (max |d|), with the reward head unfused and as the kernel's operator
    (its plain version on the CPU)."""
    ckpt, _, sample, expected = mirror_case
    res = parity_check.main(["--ckpt", str(ckpt), "--tiny", "--sample",
                             str(sample), "--expected", str(expected),
                             "--device", "cpu"]
                            + (["--fused"] if fused else []))
    printed = capsys.readouterr().out
    assert res["unmatched"] == res["dropped"] == res["seeded"] == []
    assert "FAIL" not in printed and "worst deviation" in printed
    assert res["rows"].keys() == {"traversability_preds"}
    print(f"parity_check {'fused' if fused else 'unfused'}: worst "
          f"{res['worst']:.3e} (bar {TOL})")
    assert res["worst"] <= TOL


def test_parity_check_with_torchscript_trace(mirror_case, capsys):
    """``--trace``: the weights come from the trace's state_dict and the
    trace run on the sample is the reference; every compared map (reward,
    full reward, the three decoder heads, metric depth) to <= 1e-3. Only
    the splat's geometry buffers are unmatched, and no key is dropped or
    missing."""
    _, trace, sample, _ = mirror_case
    res = parity_check.main(["--ckpt", str(trace), "--trace", "--tiny",
                             "--sample", str(sample), "--device", "cpu"])
    printed = capsys.readouterr().out
    # a trace's state_dict also holds the splat's geometry buffers, which
    # the port makes from its config: reported, and nothing else
    assert sorted(res["unmatched"]) == [
        f"backbone.cam2map.{k}"
        for k in ("lidar2map", "max_bound", "min_bound", "voxel_size")]
    assert res["dropped"] == res["seeded"] == []
    assert "FAIL" not in printed and "traversability_preds" in printed
    assert set(res["rows"]) == set(parity_check.TRACE_KEYS)
    print(f"parity_check --trace: {res['rows']}")
    assert res["worst"] <= TOL


def test_parity_check_runs_on_the_card_by_default():
    """Without ``--device`` the entry point asks for CUDA (and raises here,
    where there is none)."""
    assert parity_check.parser().parse_args(["--ckpt", "x"]).device == "cuda"
    assert compile_cli.parser().parse_args([]).device == "cuda"
    assert serve.parser().parse_args([]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            compile_cli.main(["--tiny", "--out", "/nonexistent/x.pt2"])


def test_compile_exports_and_reloads(tmp_path, capsys):
    """``compile --tiny --fused --device cpu``: the program is saved,
    reloads, and its outputs equal the eager graph's exactly (the same CPU
    kernels); the native artifact's manifest has 2 inputs and one line per
    kept output; ``--latency`` reports the engine's keys. (The unfused
    graph's export: tests/test_torch_runtime.py.)"""
    out = tmp_path / "g.pt2"
    res = compile_cli.main(["--tiny", "--fused", "--device", "cpu",
                            "--out", str(out),
                            "--native-dir", str(tmp_path / "native"),
                            "--native-outputs",
                            "traversability_preds,bev_features", "--latency"])
    printed = capsys.readouterr().out
    assert "exported" in printed and "reload" in printed
    assert res["reload_max_abs"] == 0.0
    assert res["native"]["num_outputs"] == 2
    manifest = (tmp_path / "native" / "manifest.txt").read_text().split("\n")
    assert manifest[:3] == ["format torch_export",
                            "input rgbd f32 1,1,64,80,4",
                            "input p2p f32 1,1,4,4"]
    assert manifest[3:5] == ["output bev_features f32 1,32,32,16",
                             "output traversability_preds f32 1,8,16,1"]
    assert set(res["latency"]) == {"p50_ms", "p95_ms", "hz", "clock"}
    prog = load_exported(str(out))
    assert "creste.msfcn_head" in str(prog.graph)


def test_serve_answers_infer_and_healthz():
    """``serve --tiny --fused --device cpu`` in a thread: one ``POST
    /infer`` of a frame other than the warm-up one returns the engine's
    reward for that frame bit for bit (f32 bytes, ``X-Shape``), with and
    without an ``X-P2P`` header; ``/healthz`` answers."""
    server, engine, stats = serve.build_server(
        ["--tiny", "--fused", "--device", "cpu", "--host", "127.0.0.1",
         "--port", "0"])
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        port = server.server_address[1]
        cfg = compile_cli.deployment_config(True)
        rgbd, p2p = compile_cli.example_inputs(*compile_cli.image_size(cfg),
                                               seed=5)
        p2p = p2p.copy()
        p2p[..., 2, 3] = 0.25  # another camera height than the default
        want = engine.step(rgbd, p2p)["traversability_preds"].numpy()
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/infer", data=rgbd.tobytes(),
            headers={"X-P2P": json.dumps(p2p.reshape(-1).tolist())})
        with urllib.request.urlopen(req, timeout=60) as r:
            shape = json.loads(r.headers["X-Shape"])
            got = np.frombuffer(r.read(), np.float32).reshape(shape)
        assert got.shape == want.shape == (1, 8, 16, 1)
        assert np.array_equal(got, want)
        req = urllib.request.Request(f"http://127.0.0.1:{port}/infer",
                                     data=rgbd.tobytes())
        with urllib.request.urlopen(req, timeout=60) as r:
            got0 = np.frombuffer(r.read(), np.float32)
        want0 = engine.step(rgbd, compile_cli.example_inputs(
            *compile_cli.image_size(cfg))[1])["traversability_preds"]
        assert np.array_equal(got0, want0.numpy().reshape(-1))
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=60) as r:
            health = json.loads(r.read())
        assert health["status"] == "ok" and health["input_hw"] == [64, 80]
        assert health["hz"] == round(stats["hz"], 1)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert isinstance(engine, InferenceEngine)
