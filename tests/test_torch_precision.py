"""The port's opt-in bf16 graph and its folded-BatchNorm graph against the
JAX package's, on the CPU at the tiny deployment preset.

One seeded flax-shaped tree with jittered BatchNorms drives both sides
(``tests.test_torch_helpers``); the JAX graphs are ``MaxEntIRL.apply``
jitted once each: f32, bf16 (``compute_dtype`` with ``cast_variables``),
f32 under ``folded_inference_bn`` and bf16 under it. Bars, as max|d| /
max(1, max|ref|):

- ``cast_state`` against ``cast_variables``: exact, in dtype and value.
- bf16: the dtype of every output equals JAX's (``bev_features`` bf16,
  ``depth_preds_metric`` and the reward f32, as tests/test_precision.py
  asserts). The maps before the splat: two bf16 streams that round after
  different ops (XLA fuses elementwise chains and rounds once per fusion,
  torch rounds after every op) lie apart by bf16's rounding, which the
  EffNet trunk grows to 1e-2..1e-1 of the maps; the control, the port's
  f32 graph against JAX's bf16 one, measures that noise on the same
  weights, and the port's bf16 maps must lie within ``BF16_NOISE_RATIO``
  times it of JAX's (two independent roundings lie sqrt(2) times one
  apart). Past the splat the bf16 depth moves the splat's weights, so the
  maps end to end are printed beside their control, and the later stages
  are held from JAX's own bf16 input to each: the splat and the decoder
  to ``BF16_STAGE_RTOL`` (a few bf16 roundings of the decoder's ~15
  layers), the f32 islands (the depth head from the bf16 features, the
  reward head from the input view) to ``ISLAND_RTOL``, with a control
  (the reward head run in bf16) that must land above it.
- fold_bn, f32: the backbone's maps end to end and every later stage from
  JAX's own input to it (the splat, the decoder, the reward head, fused
  and unfused) to ``FOLD_RTOL`` = 1e-5 against the JAX graph under
  ``folded_inference_bn``; the unfolded graphs' distance is printed
  beside. The weights are the helpers' default seed (0); their
  conditioning sets the backbone's f32 distance (seeds 0, 1 and 3: ~1e-6
  folded and unfolded; seed 2: 5e-6 to 8e-6 unfolded, 1.3e-5 to 2.1e-5
  folded, a near-cancellation of f32 rounding in its trunk).
- fold_bn + bf16: the same dtypes as JAX's, its backbone maps within
  ``BF16_NOISE_RATIO`` of the control, the depth head from JAX's features
  and the reward from JAX's input view to ``ISLAND_RTOL``.
- One folded BatchNorm: its (w, b) kept in f32 and in the stream dtype,
  its output in the input's dtype within ``FOLD_RTOL`` of the unfolded
  eval form (f32) or within one bf16 rounding of it (bf16); an input of a
  dtype it was not folded for raises.
"""
import jax
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from creste_public_tpu.config import presets as jpresets
from creste_public_tpu.models.blocks.convnets import folded_inference_bn
from creste_public_tpu.models.lfd import MaxEntIRL as JMaxEntIRL
from creste_public_tpu.runtime.precision import cast_variables
from creste_public_tpu_torch.models.blocks.convnets import (
    BatchNorm,
    fold_batch_norms,
)
from creste_public_tpu_torch.models.lfd import MaxEntIRL
from creste_public_tpu_torch.runtime.compile import example_inputs
from creste_public_tpu_torch.runtime.export import build_inference_fn
from creste_public_tpu_torch.runtime.precision import (
    cast_module,
    cast_state,
    max_abs_deviation,
)
from creste_public_tpu_torch.weights import from_jax_variables
from tests.test_torch_helpers import jax_variables, jitter_bn, seeded_variables
from tests.test_torch_step_helpers import one_torch_thread  # noqa: F401

BF16_NOISE_RATIO = 2.0
BF16_STAGE_RTOL = 5e-2
ISLAND_RTOL = 1e-5
FOLD_RTOL = 1e-5
BACKBONE_MAPS = ("depth_preds_feats", "dino_pe_feats", "depth_preds_logits")


def rel(got, ref) -> float:
    a = np.asarray(torch.as_tensor(got).float().numpy(), np.float64)
    b = np.asarray(np.asarray(ref, np.float32), np.float64)
    return float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))


def t32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


@pytest.fixture(scope="module")
def graphs():
    cfg = jpresets.tiny_traversability_config().to_dict()
    cfg["solve_mdp"] = False
    rgbd, p2p = example_inputs(64, 80, depth_mm=3000.0)
    jm = JMaxEntIRL(cfg)
    jm16 = JMaxEntIRL(dict(cfg, compute_dtype="bfloat16"))
    flat = jitter_bn(seeded_variables(jm, rgbd, p2p))
    jv = jax_variables(flat)
    jv16 = cast_variables(jv)

    def run(model, fold):
        def f(v, r, p):
            with folded_inference_bn(fold):
                return model.apply(v, r, p, train=False)
        return jax.jit(f)

    ref = {"f32": run(jm, False)(jv, rgbd, p2p),
           "bf16": run(jm16, False)(jv16, rgbd, p2p),
           "fold": run(jm, True)(jv, rgbd, p2p),
           "fold_bf16": run(jm16, True)(jv16, rgbd, p2p)}
    return cfg, rgbd, p2p, flat, jv16, ref


def test_cast_state_matches_cast_variables(graphs):
    """``cast_state`` of the port's state equals JAX ``cast_variables`` of
    the same tree leaf by leaf: the same dtype (BatchNorm leaves f32, every
    conv and dense weight and bias bf16) and the same value (exact).
    ``cast_module`` casts a model the same way and leaves its geometry
    constants (non-persistent buffers) f32."""
    cfg, _, _, flat, jv16, _ = graphs
    state = cast_state(from_jax_variables(flat))
    jflat = flatten_dict(dict(jv16), sep="/")
    # from_jax_variables maps each flax leaf to one key, in order
    port_keys = list(from_jax_variables(flat))
    assert len(port_keys) == len(jflat) == len(state)
    n16 = 0
    for fkey, pkey in zip(flat, port_keys):
        jleaf = jflat[fkey]
        assert str(state[pkey].dtype) == f"torch.{jleaf.dtype}", fkey
        want = from_jax_variables({fkey: np.asarray(jleaf, np.float32)})
        assert torch.equal(state[pkey].float(), next(iter(want.values()))), \
            fkey
        n16 += state[pkey].dtype == torch.bfloat16
    assert 0 < n16 < len(state)
    model = cast_module(MaxEntIRL(dict(cfg, compute_dtype="bfloat16")))
    assert {k: v.dtype for k, v in model.state_dict().items()} == {
        k: v.dtype for k, v in state.items()}
    assert all(b.dtype == torch.float32
               for b in model.backbone.cam2map.buffers())


def _stage_outputs(fn, ref, p2p):
    """The port's stages run from JAX's own inputs to each: the splat from
    JAX's depth and features, the decoder from JAX's BEV features, the
    depth head from JAX's features, the reward head (as the graph runs it)
    from JAX's input view."""
    m = fn.graph.model
    dt = next(m.backbone.bevclassifier.parameters()).dtype
    feats = t32(ref["depth_preds_feats"]).to(dt)
    B, Hs, Ws, Z = feats.shape
    depth = t32(ref["depth_preds_metric"]).reshape(B, 1, Hs, Ws)
    with torch.no_grad():
        splat = m.backbone.cam2map(depth, feats.reshape(B, 1, Hs, Ws, Z),
                                   torch.from_numpy(p2p))
        dec = m.backbone.bevclassifier(
            {"bev_features": t32(ref["bev_features"]).to(dt)})
        logits = m.backbone.depthcomp.depthcomp.predict_depth(
            feats.permute(0, 3, 1, 2))["depth_preds_logits"]
        iv = t32(ref["input_view"])
        if fn.graph.fused_reward:
            reward = torch.ops.creste.msfcn_head(iv,
                                                 fn.graph.head_tensors())
        else:
            reward = m.traversability_head.reward(iv)
    out = {"splat bev_features": (splat["bev_features"],
                                  ref["bev_features"]),
           "depth head logits": (logits, ref["depth_preds_logits"]),
           "reward head": (reward, ref["traversability_preds"])}
    out.update({f"decoder {k}": (v, ref[k]) for k, v in dec.items()
                if k.endswith("_preds")})
    return out


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_bf16_graph_matches_jax_bf16_graph(graphs, fused):
    """The bf16 deployment graph against JAX's, unfused and with the
    kernel's operator (bars in the module docstring)."""
    cfg, rgbd, p2p, flat, _, ref = graphs
    state = from_jax_variables(flat)
    fn = build_inference_fn(cfg, state, "cpu", fused_reward=fused,
                            compute_dtype="bfloat16")
    out = fn(rgbd, p2p)
    out32 = build_inference_fn(cfg, state, "cpu", fused_reward=fused)(
        rgbd, p2p)
    r16 = ref["bf16"]
    assert out.keys() == r16.keys()
    for k in r16:
        assert str(out[k].dtype) == f"torch.{r16[k].dtype}", k
    assert out["bev_features"].dtype == torch.bfloat16
    assert out["depth_preds_metric"].dtype == torch.float32
    assert out["traversability_preds"].dtype == torch.float32
    assert all(bool(torch.isfinite(v.float()).all()) for v in out.values())
    for k in BACKBONE_MAPS:
        d, control = rel(out[k], r16[k]), rel(out32[k], r16[k])
        print(f"bf16 {k}: port bf16 vs JAX bf16 {d:.3e}; control port f32 "
              f"vs JAX bf16 {control:.3e} (bar {BF16_NOISE_RATIO} x)")
        assert d <= BF16_NOISE_RATIO * control, k
    for k in sorted(r16):
        if k not in BACKBONE_MAPS and k != "depth_preds_bins":
            print(f"bf16 end to end {k}: {rel(out[k], r16[k]):.3e}; control "
                  f"port f32 {rel(out32[k], r16[k]):.3e}")
    for name, (got, want) in _stage_outputs(fn, r16, p2p).items():
        bar = ISLAND_RTOL if name in ("depth head logits", "reward head") \
            else BF16_STAGE_RTOL
        print(f"bf16 stage {name} from JAX's input: {rel(got, want):.3e} "
              f"(bar {bar})")
        assert rel(got, want) <= bar, name
    # control: the reward head computed in bf16 misses the f32 island's bar
    head = fn.graph.model.traversability_head.r
    iv = t32(r16["input_view"]).permute(0, 3, 1, 2)
    with torch.no_grad():
        in_bf16 = head(iv.to(torch.bfloat16)).permute(0, 2, 3, 1)
    control = rel(in_bf16, r16["traversability_preds"])
    print(f"control: reward head in bf16 {control:.3e} > {ISLAND_RTOL}")
    assert control > 10 * ISLAND_RTOL


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_fold_bn_matches_jax_folded_graph(graphs, fused):
    """Every stage of the f32 ``fold_bn`` graph from JAX's own input to it,
    and the backbone's maps end to end, within ``FOLD_RTOL`` of the JAX
    graph under ``folded_inference_bn``."""
    cfg, rgbd, p2p, flat, _, ref = graphs
    fn = build_inference_fn(cfg, from_jax_variables(flat), "cpu",
                            fused_reward=fused, fold_bn=True)
    bns = [m for m in fn.graph.modules() if hasattr(m, "folded")]
    assert bns and all(m.folded for m in bns)
    out = fn(rgbd, p2p)
    out32 = build_inference_fn(cfg, from_jax_variables(flat), "cpu",
                               fused_reward=fused)(rgbd, p2p)
    rf = ref["fold"]
    for k in BACKBONE_MAPS:
        print(f"fold_bn {k}: {rel(out[k], rf[k]):.3e} (bar {FOLD_RTOL}); "
              f"unfolded {rel(out32[k], ref['f32'][k]):.3e}")
        assert rel(out[k], rf[k]) <= FOLD_RTOL, k
    for name, (got, want) in _stage_outputs(fn, rf, p2p).items():
        print(f"fold_bn stage {name}: {rel(got, want):.3e}")
        assert rel(got, want) <= FOLD_RTOL, name
    end = rel(out["traversability_preds"], rf["traversability_preds"])
    print(f"fold_bn end to end reward {end:.3e}")


def test_fold_bn_bf16_runs(graphs):
    """fold_bn with the bf16 stream: JAX's dtypes, finite outputs, the
    backbone maps within ``BF16_NOISE_RATIO`` times the control of JAX's
    folded bf16 graph, and the depth head from JAX's features and the
    reward from JAX's input view within ``ISLAND_RTOL``; its distance
    from the unfolded bf16 graph is printed."""
    cfg, rgbd, p2p, flat, _, ref = graphs
    state = from_jax_variables(flat)
    fn = build_inference_fn(cfg, state, "cpu", fused_reward=True,
                            fold_bn=True, compute_dtype="bfloat16")
    out = fn(rgbd, p2p)
    out32 = build_inference_fn(cfg, state, "cpu", fused_reward=True,
                               fold_bn=True)(rgbd, p2p)
    rf = ref["fold_bf16"]
    for k in rf:
        assert str(out[k].dtype) == f"torch.{rf[k].dtype}", k
    assert all(bool(torch.isfinite(v.float()).all()) for v in out.values())
    for k in BACKBONE_MAPS:
        d, control = rel(out[k], rf[k]), rel(out32[k], rf[k])
        print(f"fold_bn bf16 {k}: {d:.3e}; control {control:.3e}")
        assert d <= BF16_NOISE_RATIO * control, k
    stages = _stage_outputs(fn, rf, p2p)
    for name in ("depth head logits", "reward head"):
        print(f"fold_bn bf16 stage {name} from JAX's input: "
              f"{rel(*stages[name]):.3e} (bar {ISLAND_RTOL})")
        assert rel(*stages[name]) <= ISLAND_RTOL, name
    plain16 = build_inference_fn(cfg, state, "cpu", fused_reward=True,
                                 compute_dtype="bfloat16")(rgbd, p2p)
    dev = max_abs_deviation(out["traversability_preds"],
                            plain16["traversability_preds"])
    print(f"fold_bn bf16 vs bf16 reward max|d| {dev:.3e}")


def test_folded_batch_norm_keeps_each_dtype_it_reads():
    """A BatchNorm folded for a bf16 stream keeps its (w, b) in f32 (the f32
    islands read f32) and in bf16, answers each input in its dtype from
    the matching pair (bars in the module docstring) and raises on another
    dtype instead of folding again."""
    g = torch.Generator().manual_seed(0)
    bn = BatchNorm(8).eval()
    with torch.no_grad():
        for t in (bn.weight, bn.bias, bn.running_mean):
            t.copy_(torch.randn(8, generator=g))
        bn.running_var.copy_(torch.rand(8, generator=g) + 0.5)
    x = torch.randn(2, 8, 5, 6, generator=g)
    with torch.no_grad():
        want = bn(x).numpy()
        fold_batch_norms(bn, torch.bfloat16)
        assert bn.folded
        assert bn.fold_w_float32.dtype == bn.fold_b_float32.dtype \
            == torch.float32
        assert bn.fold_w_bfloat16.dtype == torch.bfloat16
        got = bn(x)
        assert got.dtype == torch.float32
        assert rel(got, want) <= FOLD_RTOL
        got16 = bn(x.to(torch.bfloat16))
        assert got16.dtype == torch.bfloat16
        print(f"folded BatchNorm: f32 {rel(got, want):.3e}, bf16 "
              f"{rel(got16, want):.3e} (bars {FOLD_RTOL}, {2 ** -7})")
        assert rel(got16, want) <= 2 ** -7
        with pytest.raises(AttributeError, match="fold_w_float16"):
            bn(x.half())
