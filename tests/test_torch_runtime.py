"""The port's runtime (``runtime.export``, ``runtime.benchmark``, the
``creste::msfcn_head`` operator) on the CPU at the tiny deployment preset,
against the JAX package's ``runtime/export.py`` where it has a
counterpart.

Exactness: a program reloaded with ``torch.export.load`` runs the same CPU
kernels as the eager graph, so its outputs are held bit for bit, as is
``InferenceEngine.step`` against ``build_inference_fn``; the manifest is
held line for line (name, dtype token, dims) to the JAX package's for the
same config and inputs; the operator's fake implementation is held to the
plain version's shape and dtype.
"""
import contextlib

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from creste_public_tpu.config import presets as jpresets
from creste_public_tpu.runtime.export import (
    export_native_artifacts as jexport_native,
)
from creste_public_tpu_torch import weights
from creste_public_tpu_torch.models.lfd import MaxEntIRL
from creste_public_tpu_torch.ops import reward_kernel as rk
from creste_public_tpu_torch.runtime import benchmark
from creste_public_tpu_torch.runtime.compile import example_inputs
from creste_public_tpu_torch.runtime.export import (
    InferenceEngine,
    build_inference_fn,
    export_inference_graph,
    export_native_artifacts,
    load_exported,
)
from creste_public_tpu_torch.weights import from_jax_variables
from tests.test_torch_helpers import jax_variables, jitter_bn, seeded_variables
from tests.test_torch_step_helpers import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def tiny():
    cfg = jpresets.tiny_traversability_config().to_dict()
    cfg["solve_mdp"] = False
    rgbd, p2p = example_inputs(64, 80, depth_mm=3000.0)
    model = weights.init_weights(MaxEntIRL(cfg), 0)
    weights.jitter_reward_head_bns(model.traversability_head.r, 1)
    return cfg, rgbd, p2p, model.state_dict()


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_exported_graph_reloads_equal_to_eager(tiny, tmp_path, fused):
    """``export_inference_graph`` saves the graph; ``load_exported`` gives a
    program whose outputs equal the eager graph's bit for bit, for every
    key; the fused program calls ``creste::msfcn_head`` (and the unfused
    one does not), and a program cut to ``output_keys`` has just those."""
    cfg, rgbd, p2p, state = tiny
    fn = build_inference_fn(cfg, state, "cpu", fused_reward=fused)
    eager = fn(rgbd, p2p)
    path = str(tmp_path / "graph.pt2")
    export_inference_graph(fn.graph, rgbd, p2p, path)
    program = load_exported(path)
    with torch.no_grad():
        got = program.module()(torch.from_numpy(rgbd), torch.from_numpy(p2p))
    assert got.keys() == eager.keys()
    for k in eager:
        assert got[k].dtype == eager[k].dtype, k
        assert torch.equal(got[k], eager[k]), k
    assert ("creste.msfcn_head" in str(program.graph)) == fused
    cut = export_inference_graph(fn.graph, rgbd, p2p,
                                 output_keys=["traversability_preds"])
    with torch.no_grad():
        out = cut.module()(torch.from_numpy(rgbd), torch.from_numpy(p2p))
    assert list(out) == ["traversability_preds"]
    assert torch.equal(out["traversability_preds"],
                       eager["traversability_preds"])


def test_bf16_graph_exports(tiny, tmp_path):
    """The fused bf16 graph exports and reloads equal to eager, keeping its
    dtypes (bf16 BEV features, f32 reward)."""
    cfg, rgbd, p2p, state = tiny
    fn = build_inference_fn(cfg, state, "cpu", fold_bn=True,
                            compute_dtype="bfloat16")
    eager = fn(rgbd, p2p)
    path = str(tmp_path / "graph16.pt2")
    export_inference_graph(fn.graph, rgbd, p2p, path)
    with torch.no_grad():
        got = load_exported(path).module()(torch.from_numpy(rgbd),
                                           torch.from_numpy(p2p))
    assert got["bev_features"].dtype == torch.bfloat16
    assert got["traversability_preds"].dtype == torch.float32
    assert all(torch.equal(got[k], eager[k]) for k in eager)


def test_op_fake_shape_and_plain_value(tiny):
    """``creste::msfcn_head``: under fake tensors it gives [B, H, W, 1] f32
    from [B, H, W, Ci] (Ci = 16 at this preset); on CPU tensors it equals ``msfcn_plain`` of the
    same folded head exactly; ``head_tensors`` / ``head_from_tensors``
    round-trip the head; ``torch.library.opcheck`` passes."""
    cfg, _, _, state = tiny
    m = MaxEntIRL(cfg)
    m.load_state_dict(state)
    folded = rk.fold_msfcn_params(m.traversability_head.r)
    tensors = rk.head_tensors(folded)
    assert len(tensors) == 27
    again = rk.head_from_tensors(tensors)
    for chain in rk.HEAD:
        for a, b in zip(again[chain], folded[chain]):
            assert a.keys() == b.keys()
            assert all(a[k] is b[k] for k in a)
    x = torch.randn(2, 8, 16, 16, generator=torch.Generator().manual_seed(0))
    got = torch.ops.creste.msfcn_head(x, tensors)
    assert torch.equal(got, rk.msfcn_plain(folded, x))
    with FakeTensorMode() as mode:
        fx = mode.from_tensor(torch.empty(3, 6, 10, 16))
        fw = [mode.from_tensor(t) for t in tensors]
        out = torch.ops.creste.msfcn_head(fx, fw)
    assert tuple(out.shape) == (3, 6, 10, 1) and out.dtype == torch.float32
    torch.library.opcheck(torch.ops.creste.msfcn_head.default, (x, tensors),
                          test_utils=("test_schema", "test_faketensor"))


def test_manifest_matches_jax(tiny, tmp_path):
    """The native artifact's manifest lists the same inputs and outputs as
    the JAX package's ``export_native_artifacts`` for the same config and
    inputs: one line each, by name, dtype token and dims (the first line
    names the format: ``torch_export`` here, ``mlir`` there)."""
    cfg, rgbd, p2p, _ = tiny
    from creste_public_tpu.models.lfd import MaxEntIRL as JMaxEntIRL

    flat = jitter_bn(seeded_variables(JMaxEntIRL(cfg), rgbd, p2p))
    jexport_native(cfg, jax_variables(flat), rgbd, p2p, str(tmp_path / "j"))
    info = export_native_artifacts(cfg, from_jax_variables(flat), rgbd, p2p,
                                   str(tmp_path / "t"), device="cpu")
    jlines = (tmp_path / "j" / "manifest.txt").read_text().splitlines()
    tlines = (tmp_path / "t" / "manifest.txt").read_text().splitlines()
    assert jlines[0] == "format mlir" and tlines[0] == "format torch_export"
    assert sorted(tlines[1:]) == sorted(jlines[1:])
    assert info["manifest_lines"] == len(tlines)
    assert info["num_outputs"] == len(tlines) - 3
    program = load_exported(str(tmp_path / "t" / "program.pt2"))
    assert program.state_dict  # the weights travel inside the program


def test_engine_step_equals_inference_fn(tiny):
    """``InferenceEngine.step`` is ``build_inference_fn`` on the engine's
    device, bit for bit, for the fused and the folded bf16 graph;
    ``latency_stats`` has the JAX engine's keys (p50_ms, p95_ms, hz) and
    says which clock timed it."""
    cfg, rgbd, p2p, state = tiny
    for kw in ({}, {"fold_bn": True, "compute_dtype": "bfloat16"}):
        eng = InferenceEngine(cfg, state, "cpu", **kw)
        want = build_inference_fn(cfg, state, "cpu", **kw)(rgbd, p2p)
        got = eng.step(rgbd, p2p)
        assert all(torch.equal(got[k], want[k]) for k in want)
    stats = eng.latency_stats(rgbd, p2p, iters=3)
    assert set(stats) == {"p50_ms", "p95_ms", "hz", "clock"}
    assert stats["clock"] == "host" and stats["hz"] > 0


def test_cost_stats_and_mfu_fields(tiny):
    """``cost_stats`` counts the unfused graph's convolutions and products
    (the same FLOPs for the fused graph: the count comes from the unfused
    one) and bytes of at least the weights, inputs and outputs;
    ``mfu_fields`` reads them against the H100 constants."""
    cfg, rgbd, p2p, state = tiny
    unfused = build_inference_fn(cfg, state, "cpu", fused_reward=False).graph
    fused = build_inference_fn(cfg, state, "cpu").graph
    x, p = torch.from_numpy(rgbd), torch.from_numpy(p2p)
    c_unfused = benchmark.cost_stats(unfused, x, p)
    c_fused = benchmark.cost_stats(fused, x, p, flops_graph=unfused)
    assert c_fused["flops"] == c_unfused["flops"] > 1e6
    n_params = sum(t.numel() for t in unfused.state_dict().values())
    assert c_unfused["bytes"] > 4 * n_params
    f = benchmark.mfu_fields(c_unfused["flops"], c_unfused["bytes"], 1e-3)
    assert f["achieved_tflops"] == pytest.approx(c_unfused["flops"] / 1e9)
    assert f["share_of_bf16_peak"] == pytest.approx(
        f["achieved_tflops"] * 1e12 / benchmark.H100_PEAK_BF16_FLOPS)
    # frame_latency_ms times the card and refuses to time anything else
    with pytest.raises(RuntimeError) if not torch.cuda.is_available() \
            else contextlib.nullcontext():
        benchmark.frame_latency_ms(lambda a, b: None, rgbd, p2p)
