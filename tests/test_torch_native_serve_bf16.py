"""The bf16 deployment package served by the libtorch host
(``csrc/serve_host.cpp``) on the CPU: ``compile --bf16 --fused
--native-dir D --native-package`` at the tiny preset, the counterpart of
the JAX package's ``scripts/runtime/compile.py --bf16 --native-dir D``
for its C++ host. A file of its own, so that ``--dist loadfile`` puts its
CPU package compile (~2 minutes) on another worker than
``tests/test_torch_native_serve.py``'s f32 one.

One module fixture builds the host with g++ (``ops._build.build_host``),
exports the tiny fused bf16 graph (``compute_dtype="bfloat16"``) with the
weights of a seeded flax tree (jittered BatchNorms) moved by
``weights.from_jax_variables``, AOT-compiles it into the artifact's
package and runs the host once over it with ``--in`` (written in the
manifest's dtypes), ``--dump`` and ``--pipeline 2``.

Bars, as max|d| / max(1, max|ref|) against the port's eager bf16 graph
on the same frame (``tests/test_torch_precision.py``'s), end to end: the
trunk's maps (``BACKBONE_MAPS``) to ``BF16_STAGE_RTOL`` = 5e-2
(AOTInductor fuses the bf16 stream's elementwise chains and rounds once
per fusion, the eager graph after every op: 5.6e-03 to 1.3e-02 here);
the metric depth, the softmax expectation over the depth bins, turns the
logits' bf16 noise into 8.1e-02 of its scale, and from it the splat's
weights move, so the metric depth and every key after it are held to
``BF16_FRAME_RTOL`` = 1.0, above the largest reading (``bev_features``
0.63; the reward 0.14). What holds them is each stage run by the eager
graph from the host's own dumped input to it
(``native_serve.eager_stages``): a bf16 map to ``BF16_STAGE_RTOL`` (here
up to 1.5e-02, the decoder), an f32 one (an island: the depth head, the
splat's densities and coordinates, the input view, the full reward map)
to ``ISLAND_RTOL`` = 1e-5 (here up to 3.9e-06), the depth bins equal on
``INT_AGREE`` of their entries (here all); and the reward from the
host's own dumped input view to ``ISLAND_RTOL`` of the plain head.
``-s`` prints them all, the end-to-end ones beside the bf16 stream's own
noise (the eager f32 graph's distance from the eager bf16 graph).
"""
import os
import shutil
import subprocess

import pytest
import torch

from creste_public_tpu.config import presets as jpresets
from creste_public_tpu.models.lfd import MaxEntIRL as JMaxEntIRL
from creste_public_tpu.runtime.export import (
    export_native_artifacts as jexport_native,
)
from creste_public_tpu.runtime.precision import cast_variables
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
BACKBONE_MAPS = ("depth_preds_feats", "depth_preds_logits", "dino_pe_feats")
BF16_STAGE_RTOL = 5e-2
BF16_FRAME_RTOL = 1.0
INT_AGREE = 0.999
ISLAND_RTOL = 1e-5
BF16 = "bfloat16"
ITERS, WARMUP, PIPELINE = 3, 1, 2


def rel(got: torch.Tensor, ref: torch.Tensor) -> float:
    got, ref = got.double(), ref.double()
    return float((got - ref).abs().max()) / max(1.0, float(ref.abs().max()))


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    cfg = jpresets.tiny_traversability_config().to_dict()
    cfg["solve_mdp"] = False
    rgbd, p2p = example_inputs(64, 80, depth_mm=3000.0)
    flat = jitter_bn(seeded_variables(JMaxEntIRL(cfg), rgbd, p2p))
    state = from_jax_variables(flat)
    base = tmp_path_factory.mktemp("native_bf16")
    artifact = str(base / "artifact")
    host = _build.build_host(False)
    info = export_native_artifacts(cfg, state, rgbd, p2p, artifact,
                                   fused_reward=True, compute_dtype=BF16,
                                   device="cpu", package=True)
    inputs = native_serve.write_inputs(str(base / "in"),
                                       {"rgbd": rgbd, "p2p": p2p}, artifact)
    dump = str(base / "dump")
    report = native_serve.run_host(
        artifact, "cpu", iters=ITERS, warmup=WARMUP, distinct=2,
        pipeline=PIPELINE, inputs=inputs, dump=dump)
    eager = build_inference_fn(cfg, state, "cpu", compute_dtype=BF16)
    return dict(cfg=cfg, rgbd=rgbd, p2p=p2p, flat=flat, state=state,
                artifact=artifact, host=host["host"], info=info, dump=dump,
                report=report, got=native_serve.read_dump(dump, artifact),
                eager=eager, ref=eager(rgbd, p2p), base=base)


def test_manifest_matches_jax_bf16(served, tmp_path):
    """The manifest lists the inputs and outputs of the JAX package's
    ``export_native_artifacts`` of the bf16 config with
    ``cast_variables``: the same names, dtypes and dims, line for line
    after ``format``, bf16 where the stream leaves the graph; it ends with
    the package's line."""
    cfg16 = dict(served["cfg"], compute_dtype=BF16)
    jexport_native(cfg16, cast_variables(jax_variables(served["flat"])),
                   served["rgbd"], served["p2p"], str(tmp_path / "j"))
    jlines = (tmp_path / "j" / "manifest.txt").read_text().splitlines()
    tlines = open(os.path.join(served["artifact"], "manifest.txt")
                  ).read().splitlines()
    assert tlines[1:-1] == jlines[1:]
    assert tlines[-1] == "package host.pt2 cpu"
    spec = native_serve.read_manifest(served["artifact"])
    assert spec["input"]["rgbd"][0] == spec["input"]["p2p"][0] == "f32"
    assert spec["output"]["bev_features"][0] == "bf16"
    assert spec["output"][REWARD][0] == "f32"
    assert served["info"]["package_bytes"] == os.path.getsize(
        os.path.join(served["artifact"], "host.pt2"))


def test_outputs_follow_the_manifest(served):
    """Every output the host dumped has the manifest's dtype and dims (the
    dump's size in bytes), and the JSON line lists each once, in the
    manifest's order."""
    outputs = native_serve.read_manifest(served["artifact"])["output"]
    report = served["report"]
    assert [o["name"] for o in report["outputs"]] == list(outputs)
    for name, (token, dims) in outputs.items():
        t = served["got"][name]
        assert t.dtype == native_serve._DTYPES[token], name
        assert tuple(t.shape) == dims, name
        assert os.path.getsize(os.path.join(
            served["dump"], f"{name}.bin")) == t.numel() * t.element_size()


def test_outputs_match_eager_bf16_graph(served):
    """The host's outputs against the port's eager bf16 graph on the same
    frame: the same keys and dtypes, every floating key finite; the
    trunk's maps (``BACKBONE_MAPS``) to ``BF16_STAGE_RTOL``, every other
    floating key within ``BF16_FRAME_RTOL``; ``-s`` prints each beside
    the bf16 stream's own noise (the eager f32 graph's distance)."""
    got, ref = served["got"], served["ref"]
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        assert got[k].dtype == v.dtype, k
    f32 = build_inference_fn(served["cfg"], served["state"], "cpu")(
        served["rgbd"], served["p2p"])
    gaps = {}
    for k in sorted(ref):
        if not ref[k].is_floating_point():
            gaps[k] = float((got[k] == ref[k]).float().mean())
            continue
        assert bool(torch.isfinite(got[k].float()).all()), k
        gaps[k] = (rel(got[k], ref[k]), rel(f32[k], ref[k]))
    print("\nbf16 host vs eager bf16 graph end to end, max|d|/max(1,max|ref|"
          ") (the eager f32 graph's; an integer map's share of equal "
          "entries): " + ", ".join(
              f"{k} {v:.3e}" if isinstance(v, float) else
              f"{k} {v[0]:.3e} ({v[1]:.3e})" for k, v in gaps.items()))
    for k, v in gaps.items():
        if isinstance(v, tuple):
            bar = BF16_STAGE_RTOL if k in BACKBONE_MAPS else BF16_FRAME_RTOL
            assert v[0] <= bar, (k, v, bar)
    assert float(ref["bev_densities"].sum()) > 0  # the splat hit the grid


def test_stages_match_eager_bf16_graph_from_host_inputs(served):
    """Each stage after the trunk, run by the eager bf16 graph from the
    host's own dumped input to it (``native_serve.eager_stages``: the
    depth head, the splat, the decoder, the input view, the full reward
    map), against the host's output: a bf16 map to ``BF16_STAGE_RTOL``,
    an f32 one (an island) to ``ISLAND_RTOL``, an integer map equal on
    ``INT_AGREE`` of its entries."""
    stages = native_serve.eager_stages(served["eager"].graph, served["got"],
                                       served["p2p"])
    held = {}
    for name, (want, got) in stages.items():
        assert got.dtype == want.dtype and got.shape == want.shape, name
        if not want.is_floating_point():
            held[name] = float((got == want).float().mean())
            assert held[name] >= INT_AGREE, (name, held[name])
            continue
        bar = (BF16_STAGE_RTOL if want.dtype == torch.bfloat16
               else ISLAND_RTOL)
        held[name] = rel(got, want)
        assert held[name] <= bar, (name, held[name], bar)
    print("\nbf16 host's stages from its own inputs, max|d|/max(1,max|ref|)"
          " (an integer map's share of equal entries): " + ", ".join(
              f"{k} {v:.3e}" for k, v in held.items()))
    assert {n.split()[-1] for n in stages} >= {
        "depth_preds_metric", "depth_preds_bins", "bev_features",
        "bev_coords", "elevation_preds", "input_view", f"{REWARD}_full"}


def test_reward_matches_plain_head_on_its_input_view(served):
    """The reward the host served (the C++ operator's plain version, f32)
    against ``reward_kernel.msfcn_plain`` of the eager bf16 graph's head,
    folded in f32 from its bf16-rounded weights, on the host's own dumped
    input view, to ``ISLAND_RTOL``; the reward is not constant."""
    head = served["eager"].graph.model.traversability_head.r
    folded = rk.fold_msfcn_params(head)
    got = served["got"]
    assert got["input_view"].dtype == got[REWARD].dtype == torch.float32
    ref = rk.msfcn_plain(folded, got["input_view"])
    gap = rel(got[REWARD], ref)
    print(f"\nbf16 host reward vs the plain head on its input view: "
          f"{gap:.3e} (bar {ISLAND_RTOL})")
    assert gap <= ISLAND_RTOL
    assert float(got[REWARD].std()) > 0


def test_head_runs_once_per_frame(served):
    """The package calls ``creste::msfcn_head`` once per frame the host
    served (warm-up, timed, sequential and pipelined streaming, the dumped
    frame); on the CPU it is the plain version and launches no kernel
    (the four launches per frame on the card: chip_smoke phase 43)."""
    report = served["report"]
    assert report["frames_run"] == WARMUP + 3 * ITERS + 1
    assert report["msfcn_head_calls"] == report["frames_run"]
    assert report["msfcn_head_launches"] == 0


def test_host_refuses_an_output_the_manifest_misnames(served, tmp_path):
    """A manifest that gives a bf16 output another dtype: the host serves
    by the manifest's layout, so it stops with exit 1 and names the
    output, instead of dumping bytes of another dtype."""
    art = tmp_path / "artifact"
    shutil.copytree(served["artifact"], art,
                    copy_function=os.symlink)  # the package is not copied
    manifest = art / "manifest.txt"
    manifest.unlink()
    shutil.copy(os.path.join(served["artifact"], "manifest.txt"), manifest)
    manifest.write_text(manifest.read_text().replace(
        "output bev_features bf16", "output bev_features f32"))
    r = subprocess.run([served["host"], "--artifact", str(art), "--device",
                        "cpu", "--iters", "1", "--warmup", "0",
                        "--pipeline", "0"],
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, TMPDIR=str(tmp_path)))
    assert r.returncode == 1, r.stderr[-2000:]
    assert "bev_features" in r.stderr and "manifest says f32" in r.stderr
