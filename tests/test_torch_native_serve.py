"""The libtorch serving host (``csrc/serve_host.cpp``) and the C++
registrations of ``creste::msfcn_head`` (``csrc/msfcn_head_op.cpp``) and
``creste::splat_sums`` (``csrc/splat_op.cpp``) on the CPU, mirroring ``tests/test_native_serve.py`` (the JAX package's PJRT
host).

One module fixture builds the host with g++ against the installed torch
(``ops._build.build_host``), exports the tiny fused deployment graph with
the weights of a seeded flax tree (jittered BatchNorms, so that the reward
head's last relu is alive) moved by ``weights.from_jax_variables``,
AOT-compiles it into the artifact's package (``compile --native-dir D
--native-package``) and runs the host once over it with ``--in`` (the
frame), ``--dump`` and ``--pipeline 2``. The host's process has no Python
in it; this process never loads the C++ operators' library (both register
``creste::msfcn_head`` and ``creste::splat_sums``).

Tolerances, max|d| / max(1, max|ref|) per output against the port's eager
graph on the same frame: ``PRE_SPLAT_RTOL`` = 1e-4 for the backbone's
maps, ``FRAME_RTOL`` = 2e-3 for the splat and every output after it
(AOTInductor's fused C++ kernels sum in other orders than the eager ones:
1.5e-5 of scale before the splat, ``depth_preds_metric``, and up to
3.8e-4 after it, ``bev_features``, where the depth softmax turns last bits
into shifts of the splat's weights); integer maps exactly. The host's
reward against the plain head on the host's own dumped input view to 1e-6
(the same ATen calls: it reads 0), and against the JAX
package's fused deployment graph (the Pallas head in interpret mode) at
rtol 1e-3, atol 1e-3, the bar of ``tests/test_torch_main_path.py``.
"""
import json
import os
import subprocess
import tempfile

import numpy as np
import pytest
import torch

from creste_public_tpu.config import presets as jpresets
from creste_public_tpu.models.lfd import MaxEntIRL as JMaxEntIRL
from creste_public_tpu.runtime.export import (
    build_inference_fn as jbuild_inference_fn,
)
from creste_public_tpu.runtime.export import (
    export_native_artifacts as jexport_native,
)
from creste_public_tpu_torch.ops import _build
from creste_public_tpu_torch.ops import reward_kernel as rk
from creste_public_tpu_torch.runtime import native_serve
from creste_public_tpu_torch.runtime.compile import example_inputs
from creste_public_tpu_torch.runtime.export import (
    build_inference_fn,
    export_native_artifacts,
)
from creste_public_tpu_torch.weights import from_jax_variables
from tests.test_torch_helpers import jax_variables, jitter_bn, seeded_variables
from tests.test_torch_step_helpers import one_torch_thread  # noqa: F401

REWARD = "traversability_preds"
PRE_SPLAT = ("depth_preds_feats", "depth_preds_logits", "depth_preds_metric",
             "dino_pe_feats")
PRE_SPLAT_RTOL = 1e-4
FRAME_RTOL = 2e-3
ITERS, WARMUP, PIPELINE = 3, 1, 2


def checksum(data: bytes) -> int:
    """The host's checksum of an output's raw bytes (the JAX host's)."""
    s = 0
    for b in data:
        s = (s * 131 + b) & (2**64 - 1)
    return s


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    cfg = jpresets.tiny_traversability_config().to_dict()
    cfg["solve_mdp"] = False
    rgbd, p2p = example_inputs(64, 80, depth_mm=3000.0)
    flat = jitter_bn(seeded_variables(JMaxEntIRL(cfg), rgbd, p2p))
    state = from_jax_variables(flat)
    base = tmp_path_factory.mktemp("native")
    artifact = str(base / "artifact")
    host = _build.build_host(False)
    info = export_native_artifacts(cfg, state, rgbd, p2p, artifact,
                                   fused_reward=True, device="cpu",
                                   package=True)
    inputs = native_serve.write_inputs(str(base / "in"),
                                       {"rgbd": rgbd, "p2p": p2p})
    dump = str(base / "dump")
    report = native_serve.run_host(
        artifact, "cpu", iters=ITERS, warmup=WARMUP, distinct=2,
        pipeline=PIPELINE, inputs=inputs, dump=dump)
    return dict(cfg=cfg, rgbd=rgbd, p2p=p2p, flat=flat, state=state,
                artifact=artifact, host=host["host"], info=info,
                inputs=inputs, dump=dump, report=report,
                got=native_serve.read_dump(dump, artifact))


def run(host: str, *argv: str) -> subprocess.CompletedProcess:
    """The host with a TMPDIR of its own (the package loader unpacks the
    package there and leaves it behind)."""
    with tempfile.TemporaryDirectory() as tmp:
        return subprocess.run([host, *argv], capture_output=True, text=True,
                              timeout=120, env=dict(os.environ, TMPDIR=tmp))


def test_manifest_matches_jax(served, tmp_path):
    """The artifact's manifest lists the inputs and outputs of the JAX
    package's ``export_native_artifacts`` for the same config and inputs,
    line for line after ``format``, and ends with the package's line."""
    jexport_native(served["cfg"], jax_variables(served["flat"]),
                   served["rgbd"], served["p2p"], str(tmp_path / "j"))
    jlines = (tmp_path / "j" / "manifest.txt").read_text().splitlines()
    tlines = open(os.path.join(served["artifact"], "manifest.txt")
                  ).read().splitlines()
    assert jlines[0] == "format mlir" and tlines[0] == "format torch_export"
    assert tlines[1:-1] == jlines[1:]
    assert tlines[-1] == "package host.pt2 cpu"
    assert served["info"]["manifest_lines"] == len(tlines)
    assert served["info"]["package_bytes"] == os.path.getsize(
        os.path.join(served["artifact"], "host.pt2"))


def test_round_trip_report_matches_manifest(served):
    """The host's JSON line: every manifest output once, in the manifest's
    order, with its dims, and each checksum that of the bytes it dumped;
    the timing fields, and every frame it served counted."""
    report = served["report"]
    outputs = native_serve.read_manifest(served["artifact"])["output"]
    assert [o["name"] for o in report["outputs"]] == list(outputs)
    for o in report["outputs"]:
        assert tuple(o["dims"]) == outputs[o["name"]][1]
        with open(os.path.join(served["dump"], f"{o['name']}.bin"),
                  "rb") as f:
            assert o["checksum"] == checksum(f.read()), o["name"]
    assert report["per_frame_ms"] > 0 and report["hz"] > 0
    assert report["load_s"] > 0 and report["clock"] == "host"
    assert (report["iters"], report["distinct"]) == (ITERS, 2)
    assert report["device"] == "cpu" and report["tf32"] is False
    # warm-up, timed, sequential and pipelined streaming, the dumped frame
    assert report["frames_run"] == WARMUP + 3 * ITERS + 1
    assert report["msfcn_head_launches"] == 0  # the plain version on the CPU
    assert report["msfcn_head_calls"] == report["frames_run"]  # one head


def test_host_refuses_without_artifact_or_gpu(served, tmp_path):
    """Exit 2 with a reason: no ``--artifact``; an artifact without a
    manifest; the card asked for (the default) on a machine without one;
    an ``--in`` file of the wrong size."""
    host = served["host"]
    r = run(host)
    assert r.returncode == 2 and "--artifact" in r.stderr
    r = run(host, "--artifact", str(tmp_path), "--device", "cpu")
    assert r.returncode == 2 and "manifest" in r.stderr
    assert not torch.cuda.is_available()
    r = run(host, "--artifact", served["artifact"])
    assert r.returncode == 2 and "no CUDA device" in r.stderr
    bad = tmp_path / "short.bin"
    np.zeros(5, np.float32).tofile(bad)
    r = run(host, "--artifact", served["artifact"], "--device", "cpu",
            "--in", f"p2p={bad}")
    assert r.returncode == 2 and "bytes" in r.stderr


def test_outputs_match_eager_port(served):
    """Every output the host dumped against the port's eager fused graph on
    the same frame: the backbone's maps to ``PRE_SPLAT_RTOL``, the splat
    and the rest to ``FRAME_RTOL``, integer maps exactly."""
    fn = build_inference_fn(served["cfg"], served["state"], "cpu")
    eager = fn(served["rgbd"], served["p2p"])
    got = served["got"]
    assert sorted(got) == sorted(eager)
    for k, ref in eager.items():
        assert got[k].dtype == ref.dtype, k
        if not ref.is_floating_point():
            assert torch.equal(got[k], ref), k
            continue
        gap = float((got[k] - ref).abs().max()) / max(
            1.0, float(ref.abs().max()))
        assert gap <= (PRE_SPLAT_RTOL if k in PRE_SPLAT else FRAME_RTOL), (
            k, gap)
    assert float(eager["bev_densities"].sum()) > 0  # the splat hit the grid


def test_reward_matches_plain_head_on_its_input_view(served):
    """The C++ operator's plain version in the host against
    ``reward_kernel.msfcn_plain`` on the host's own dumped input view, to
    1e-6 of scale; the reward is not constant."""
    m = build_inference_fn(served["cfg"], served["state"], "cpu").graph
    folded = rk.fold_msfcn_params(m.model.traversability_head.r)
    got = served["got"]
    ref = rk.msfcn_plain(folded, got["input_view"])
    scale = max(1.0, float(ref.abs().max()))
    assert float((got[REWARD] - ref).abs().max()) <= 1e-6 * scale
    assert float(got[REWARD].std()) > 0


def test_reward_matches_jax(served):
    """The host's reward maps against the JAX package's fused deployment
    graph (the Pallas head in interpret mode) with the same weights, at
    rtol 1e-3, atol 1e-3."""
    jv = jax_variables(served["flat"])
    jfn, _ = jbuild_inference_fn(served["cfg"], jv, fused_reward=True)
    ref = jfn(jv, served["rgbd"], served["p2p"])
    for k in (REWARD, f"{REWARD}_full"):
        np.testing.assert_allclose(served["got"][k].numpy(),
                                   np.asarray(ref[k]), rtol=1e-3, atol=1e-3,
                                   err_msg=k)
    assert float(np.std(np.asarray(ref[REWARD]))) > 0


def test_pipeline_reports_its_fields(served):
    """``--pipeline 2`` streams ``--iters`` frames one at a time and two
    in flight, and reports both with the sequential legs."""
    report = served["report"]
    assert report["pipeline_depth"] == PIPELINE
    assert report["pipeline_frames"] == ITERS
    for k in ("seq_stream_per_frame_ms", "seq_stream_hz", "seq_exec_ms",
              "pipeline_per_frame_ms", "pipeline_hz", "pipeline_speedup"):
        assert report[k] > 0, k
    for k in ("seq_h2d_ms", "seq_d2h_ms"):
        assert report[k] >= 0, k


def test_registered_schema_equals_python_op(served):
    """The C++ library registers the Python operator's schema, character
    for character."""
    assert served["report"]["msfcn_head_schema"] == str(
        torch.ops.creste.msfcn_head.default._schema)


def test_registered_splat_schema_equals_python_op(served):
    """The C++ library registers ``creste::splat_sums`` with the Python
    operator's schema, character for character, and the package calls it
    once per frame the host served; on the CPU it is the plain version and
    launches no kernel (one launch per frame on the card: chip_smoke phase
    43)."""
    report = served["report"]
    assert report["splat_sums_schema"] == str(
        torch.ops.creste.splat_sums.default._schema)
    assert report["splat_sums_calls"] == report["frames_run"]
    assert report["splat_sums_launches"] == 0
