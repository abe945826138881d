"""Spatial inference on the CPU: one frame's width split across 2 and 4
spawned gloo ranks (``parallel.spatial``, ``runtime.export.
build_spatial_inference_fn``), the rank code in
``tests/test_torch_spatial_ranks.py``.

``test_primitive_matches_unsharded``: each width-sharded primitive
(convolutions at kernels 1, 3, 5 and 7, strides 1 and 2, depthwise,
asymmetric and SAME padding; the 2x2 max-pool; the bilinear resize at the
global sizes; the full-frame mean) at widths 80, 77 and 3, gathered
back, against the op on the whole tensor, to 1e-6 absolute in f32. At
width 3 some ranks own no column of the input or the output. At width 77
the max-pool, resizes, mean and a 3x3 convolution in bf16 (in bf16 out,
within one bf16 spacing, 2^-7, of the output's scale), and the convolution's
bf16 weights on an f32 input (in f32, promoted, to 1e-6).

``test_graph_matches_one_rank``: the tiny deployment graph
(``presets.tiny_traversability_config()``, ``solve_mdp=False``) on 2 and
4 ranks, fused (the folded head's plain version on each rank's padded
strip) and unfused, built by ``build_spatial_inference_fn`` from the
variant's one-rank ``InferenceGraph`` and held against it on every rank,
for every output key (with the same dtypes), as max|d| over max(1,
max|ref|) (chip_smoke's measure), stage by stage from the one-rank
graph's input to each stage: the depth and DINO heads from the trunk's
features, the splat from the metric depth and features, the decoder and
the reward from the BEV grid, the reward head from the input view. The
jobs: f32 on two frames, and on the camera's frame every other serving
variant (``VARIANTS`` of ``tests/test_torch_spatial_ranks.py``):
``fold_bn``, the bf16 stream, bf16 + ``fold_bn``, merged heads and the
``max`` splat.

- f32 variants: every stage to ``GRAPH_TOL`` = 1e-5 with oneDNN off on
  both sides (oneDNN picks its convolution algorithm by the input's
  width, so a strip rounds differently from the frame, where torch's
  im2col GEMM sums every output in one order at any width), the trunk's
  features too; the ``max`` splat's grid from the same inputs to the bit
  (max is associative). End to end every key is held to the repo's 1e-3
  parity bar of its scale, with oneDNN on and off: the
  softmax-expectation depth turns last-bit differences of the logits (the
  squeeze-excitation means and the small bilinear resizes round
  differently on strips even with oneDNN off) into shifts of the splat's
  bilinear weights. ``-s`` prints each key's distance end to end: at the
  camera inputs up to 2.1e-05 of the metric depth's scale, 4.9e-04 of
  ``bev_features``' and 1.4e-04 of the reward's.
- bf16 variants (oneDNN on: torch's bf16 GEMM is ~100x slower on the
  CPU): the bf16 stream's stages to ``BF16_STAGE_RTOL`` = 5e-2 and the f32
  islands from their own inputs (the depth head and its metric depth and
  bins, the splat's densities and coordinates, the reward head from the
  input view) to ``ISLAND_RTOL`` = 1e-5, ``tests/test_torch_precision.
  py``'s bars. End to end a bf16 graph is as far from itself on strips as
  its bf16 rounding lets it be: the CPU's small resizes round their f32
  sums differently on strips (above), which flips last bf16 bits, and the
  depth softmax turns them into shifts of the splat. So end to end the
  trunk's maps are held to ``BF16_STAGE_RTOL`` (read up to 1.3e-02), the
  depth's geometry (the metric depth, the splat's coordinates and
  densities) to ``BF16_GEOMETRY_RTOL`` = 0.15 of its scale and the rest
  to ``BF16_FRAME_RTOL`` = 1.0, above the largest readings: 8.0e-02 (the
  coordinates) and 0.90 (the depth bins; ``bev_features`` 0.80, the
  reward 0.15). ``-s`` prints each
  beside the bf16 stream's own noise, the one-rank f32 graph's distance
  from the one-rank bf16 graph (the reward's 0.26 to 0.33).

``test_graph_matches_jax_sharded``: the 4-rank graph against the JAX
package's ``jit(..., in_shardings=spatial_inference_shardings(
make_spatial_mesh(4)))`` on the virtual CPU devices: the f32
``MaxEntIRL.apply`` on the inputs of ``tests/test_spatial_inference.py``,
and ``build_inference_fn(...)[0]`` with ``fold_bn=True`` and of the bf16
config with ``cast_variables`` on the camera's frame. f32:
``traversability_preds``, ``traversability_preds_full``, ``bev_densities``
and ``elevation_preds`` at JAX's own atol 1e-5 from JAX's backbone
outputs (of the key's scale on the camera's frame, whose densities reach
~73) and the reward head from JAX's input view; end to end at the parity
bar: end to end the one-rank graph itself reads 5.3e-05 from JAX's
``bev_densities`` (``-s`` prints it), for the reason above. bf16: every
stage from JAX's own input to it at the bars above, end to end at the
bf16 end-to-end bars above.

``test_spatial_mesh_rejects_more_ranks``: ``make_spatial_mesh(world + 1)``
raises ``ValueError("spatial mesh needs ...")`` in one process and on
every rank. The rest: a mesh over fewer ranks than the group, the
reward alone gathered (``output_keys``), the shardings' columns, the
reward head's strips, the entry point's device, the variant read from
the graph, and what the split graph refuses (the temporal merge, stage
1's branches, training mode).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from creste_public_tpu.config import presets as jpresets
from creste_public_tpu.models.lfd import MaxEntIRL as JMaxEntIRL
from creste_public_tpu.parallel import make_spatial_mesh as jmake_spatial_mesh
from creste_public_tpu.parallel import (
    spatial_inference_shardings as jspatial_inference_shardings,
)
from creste_public_tpu.runtime.export import (
    build_inference_fn as jbuild_inference_fn,
)
from creste_public_tpu.runtime.precision import cast_variables
from creste_public_tpu_torch.models.lfd import MaxEntIRL
from creste_public_tpu_torch.parallel import (
    SPATIAL_AXIS,
    make_spatial_mesh,
    spatial_inference_shardings,
)
from creste_public_tpu_torch.parallel import spatial as sp
from creste_public_tpu_torch.runtime.export import (
    build_inference_graph,
    build_spatial_inference_fn,
)
from creste_public_tpu_torch.weights import from_jax_variables
from tests.test_torch_helpers import jax_variables, jitter_bn, seeded_variables
from tests.test_torch_spatial_ranks import (
    VARIANTS,
    gemm_convolutions,
    is_bf16,
    primitive_cases,
    run_ranks,
    unsharded,
    variant_config,
    variant_graph,
)
from tests.test_torch_step_helpers import one_torch_thread  # noqa: F401

WORLDS = (2, 4)
PRIM_ATOL = 1e-6
GRAPH_TOL = 1e-5  # of each key's scale, stage by stage; JAX's atol
PARITY_BAR = 1e-3  # end to end, of each key's scale (docs/PARITY.md)
# bf16 stream stages, and the f32 islands of a bf16 graph (the depth head
# and the reward head from their inputs): tests/test_torch_precision.py's
BF16_STAGE_RTOL = 5e-2
ISLAND_RTOL = 1e-5
# end to end in bf16, of each key's scale, above the largest readings on
# the CPU (``-s`` prints them beside the bf16 stream's own noise): the
# trunk's maps (its first stage) at the stage bar, up to 1.3e-02; the
# depth's geometry up to 8.0e-02 (the coordinates); the rest up to 0.90
# (the depth bins' argmax flips; bev_features 0.80)
TRUNK_MAPS = ("depth_preds_feats", "depth_preds_logits", "dino_pe_feats")
GEOMETRY_KEYS = ("depth_preds_metric", "bev_coords", "bev_densities")
BF16_GEOMETRY_RTOL = 0.15
BF16_FRAME_RTOL = 1.0
REWARD_KEYS = ("traversability_preds", "traversability_preds_full")
JAX_KEYS = REWARD_KEYS + ("bev_densities", "elevation_preds")
SPLAT_KEYS = ("bev_features", "bev_densities", "bev_coords")
INPUTS = ("identity", "camera")
# each graph job's (frame, serving variant): f32 on both frames, every
# other variant on the camera's frame (it splats onto more of the grid)
JOBS = {name: (name, "f32") for name in INPUTS}
JOBS.update({f"camera-{v}": ("camera", v) for v in VARIANTS if v != "f32"})
# variants held to JAX's 4-device sharded graph, on the camera's frame
JAX_VARIANTS = ("fold_bn", "bf16")
F32_ISLANDS = ("depth_preds_logits", "depth_preds_metric", "bev_densities",
               "bev_coords") + REWARD_KEYS


def _inputs(name: str, h: int, w: int):
    """``identity``: the frame of tests/test_spatial_inference.py (p2p the
    identity); ``camera``: the same frame seen through a forward camera
    (tests/test_torch_main_path.py's p2p), which splats onto more of the
    grid."""
    rng = np.random.default_rng(0)
    rgbd = (rng.uniform(0, 1, (1, 1, h, w, 4)).astype(np.float32)
            * np.array([1, 1, 1, 3000], np.float32))
    p2p = np.tile(np.eye(4, dtype=np.float32), (1, 1, 1, 1))
    if name == "camera":
        fx = fy = 0.9 * w
        kinv = np.array([[1 / fx, 0, -w / 2 / fx], [0, 1 / fy, -h / 2 / fy],
                         [0, 0, 1.0]])
        rot = np.array([[0, 0, 1.0], [-1, 0, 0], [0, -1, 0]])
        p2p = np.eye(4, dtype=np.float32)
        p2p[:3, :3] = (rot @ kinv).astype(np.float32)
        p2p = p2p[None, None]
    return rgbd, p2p


def _tensor(a) -> torch.Tensor:
    """A graph's output (a tensor, or a JAX array: bf16 through f32)."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _fed(out: dict, B: int, N: int) -> dict:
    """A graph's backbone outputs, BEV grid and input view as the next
    stages' inputs."""
    depth = _tensor(out["depth_preds_metric"])
    feats = _tensor(out["depth_preds_feats"])
    return {"depth": depth.reshape(B, N, *depth.shape[1:]).contiguous(),
            "feats": feats.reshape(B, N, *feats.shape[1:]).contiguous(),
            "bev": _tensor(out["bev_features"]).contiguous(),
            "iv": _tensor(out["input_view"]).contiguous()}


@pytest.fixture(scope="module")
def tiny():
    """The tiny config, one seeded flax tree (BNs jittered) in both
    packages, the one-rank port graph of every job (fused and unfused;
    an f32 variant's with oneDNN off too), JAX's 4-device sharded graphs
    (f32 on the identity frame, ``JAX_VARIANTS`` on the camera's), and the
    ranks' results on 2 and 4 ranks (spawned once each)."""
    cfg = jpresets.tiny_traversability_config().to_dict()
    cfg["solve_mdp"] = False
    h, w = cfg["vision_backbone"]["vision_backbone"]["effnet_cfgs"][
        "image_size"]
    jm = JMaxEntIRL(cfg)
    rgbd0, p2p0 = _inputs("identity", h, w)
    flat = jitter_bn(seeded_variables(jm, jnp.asarray(rgbd0),
                                      jnp.asarray(p2p0)))
    jv = jax_variables(flat)
    shardings = jspatial_inference_shardings(jmake_spatial_mesh(4))
    jfn = jax.jit(lambda v, r, p: jm.apply(v, r, p, train=False),
                  in_shardings=shardings)
    jout = {"identity": jfn(jv, jnp.asarray(rgbd0), jnp.asarray(p2p0))}
    rgbd1, p2p1 = _inputs("camera", h, w)
    for variant in JAX_VARIANTS:
        vcfg, vv = ((dict(cfg, compute_dtype="bfloat16"), cast_variables(jv))
                    if variant == "bf16" else (cfg, jv))
        vfn = jax.jit(jbuild_inference_fn(vcfg, vv,
                                          fold_bn=variant == "fold_bn")[0],
                      in_shardings=shardings)
        jout[f"camera-{variant}"] = vfn(vv, jnp.asarray(rgbd1),
                                        jnp.asarray(p2p1))
    jout = {k: {n: _tensor(a) for n, a in v.items()} for k, v in jout.items()}
    state = from_jax_variables(flat)
    model = MaxEntIRL(cfg)
    model.load_state_dict(state, strict=True)
    model.eval()
    refs, jobs = {}, {}
    for key, (name, variant) in JOBS.items():
        rgbd, p2p = _inputs(name, h, w)
        vcfg, vstate, opts = variant_config(cfg, state, variant)
        job = dict(cfg=vcfg, state=vstate, opts=opts, rgbd=rgbd, p2p=p2p)
        args = torch.from_numpy(rgbd), torch.from_numpy(p2p)
        with torch.no_grad():
            for fused in (True, False):
                graph = variant_graph(job, fused)
                refs[key, fused] = graph(*args)
                if not is_bf16(job):
                    with gemm_convolutions():
                        refs[key, fused, "gemm"] = graph(*args)
            if is_bf16(job):  # the bf16 stream's noise: the f32 graph
                refs[key, "control"] = variant_graph(
                    dict(job, opts={}, cfg=cfg, state=state), True)(*args)
        job["fed"] = _fed(refs[key, True] if is_bf16(job)
                          else refs[key, True, "gemm"], 1, 1)
        if key in jout:
            job["jax_fed"] = _fed(jout[key], 1, 1)
        jobs[key] = job
    return dict(cfg=cfg, jout=jout, refs=refs, jobs=jobs, model=model)


@pytest.fixture(scope="module")
def ranks(tiny, tmp_path_factory):
    """world -> each rank's results (one spawn per world)."""
    return {world: run_ranks(world, tmp_path_factory.mktemp(f"w{world}"),
                             tiny["jobs"]) for world in WORLDS}


_CASES = primitive_cases()


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("index", range(len(_CASES)),
                         ids=[c["name"] for c in _CASES])
def test_primitive_matches_unsharded(ranks, world, index):
    case = _CASES[index]
    ref = unsharded(case)
    # a bf16 result within one bf16 spacing (2^-7) of its scale: a strip
    # may round a sum the other way (oneDNN's bf16 convolution and the
    # CPU's bf16 resize at odd sizes sum in another order than the frame)
    atol = (PRIM_ATOL if ref.dtype == torch.float32
            else 2.0 ** -7 * float(ref.float().abs().max()))
    for r, res in enumerate(ranks[world]):
        got = res["prims"][case["name"]]
        assert got.shape == ref.shape, (r, case["name"])
        assert got.dtype == ref.dtype, (r, case["name"])
        np.testing.assert_allclose(got.float().numpy(), ref.float().numpy(),
                                   rtol=0, atol=atol,
                                   err_msg=f"rank {r} {case['name']}")


def _np(a) -> np.ndarray:
    return _tensor(a).double().numpy()


def _close(got, want, atol, msg):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, msg
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=msg)


def _rel(got, want) -> float:
    """max|got - want| / max(1, max|want|)."""
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max()) / max(1.0, float(
        np.abs(want).max()))


def _scaled(got, want, tol, msg):
    """max|got - want| <= tol * max(1, max|want|): ``tol`` of the key's
    scale (chip_smoke's measure)."""
    want = _np(want)
    _close(got, want, tol * max(1.0, float(np.abs(want).max())), msg)


def _stage_bar(job: dict, stage: str, key: str) -> float:
    """A stage's bar, of the key's scale: ``GRAPH_TOL`` in f32 (oneDNN
    off); in a bf16 graph ``ISLAND_RTOL`` for the f32 islands fed from
    their own inputs (the depth head and its metric depth and bins, the
    splat's densities and coordinates, the reward head from the input
    view), ``BF16_STAGE_RTOL`` for the bf16 stream's stages."""
    if not is_bf16(job):
        return GRAPH_TOL
    if stage != "bev" and key in F32_ISLANDS + ("depth_preds_bins",):
        return ISLAND_RTOL
    return BF16_STAGE_RTOL


def _bf16_frame_bar(key: str) -> float:
    return (BF16_STAGE_RTOL if key in TRUNK_MAPS else BF16_GEOMETRY_RTOL
            if key in GEOMETRY_KEYS else BF16_FRAME_RTOL)


def _stages(ref: dict, res: dict) -> dict[str, tuple[str, ...]]:
    """The keys each fed stage holds: the heads' from the trunk's
    features, the splat's from the depth and the features, the rest from
    the grid, and the reward's from the input view."""
    stages = {"heads": ("depth_preds_logits", "depth_preds_metric",
                        "depth_preds_bins", "dino_pe_feats"),
              "splat": SPLAT_KEYS}
    stages["bev"] = tuple(set(ref) - {k for v in stages.values() for k in v}
                          - {"depth_preds_feats"})
    stages["reward"] = REWARD_KEYS
    return {k: v for k, v in stages.items() if k in res}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("fused", (True, False), ids=("fused", "unfused"))
@pytest.mark.parametrize("inputs", list(JOBS))
def test_graph_matches_one_rank(tiny, ranks, world, fused, inputs):
    job = tiny["jobs"][inputs]
    bf16 = is_bf16(job)
    ref = tiny["refs"][inputs, fused]
    base = ref if bf16 else tiny["refs"][inputs, fused, "gemm"]
    for r, res in enumerate(ranks[world]):
        g = res["graphs"][inputs, fused]
        assert sorted(g["e2e"]) == sorted(ref), r
        assert {k: v.dtype for k, v in g["e2e"].items()} == {
            k: v.dtype for k, v in ref.items()}, r
        if not bf16:
            assert sorted(g["e2e_gemm"]) == sorted(ref), r
            _scaled(g["e2e_gemm"]["depth_preds_feats"],
                    base["depth_preds_feats"], GRAPH_TOL,
                    f"rank {r} the trunk's features (oneDNN off)")
        for stage, keys in _stages(ref, g).items():
            for k in keys:
                _scaled(g[stage][k], base[k], _stage_bar(job, stage, k),
                        f"rank {r} {k} ({stage} stage)")
        if job["opts"].get("scatter_mode") == "max":
            for k in ("bev_features", "bev_densities"):
                assert g["splat"][k].dtype == base[k].dtype
            assert torch.equal(g["splat"]["bev_features"],
                               base["bev_features"]), r
        for k in ref:
            if bf16:
                _scaled(g["e2e"][k], ref[k], _bf16_frame_bar(k),
                        f"rank {r} {k} end to end")
                continue
            _scaled(g["e2e"][k], ref[k], PARITY_BAR,
                    f"rank {r} {k} end to end")
            _scaled(g["e2e_gemm"][k], base[k], PARITY_BAR,
                    f"rank {r} {k} end to end, oneDNN off")
    g = ranks[world][0]["graphs"][inputs, fused]
    if bf16:
        control = tiny["refs"][inputs, "control"]
        print(f"\n{world} ranks, {inputs}, fused={fused}: end to end, of "
              "each key's scale (the f32 graph's, the bf16 noise): "
              + ", ".join(f"{k} {_rel(g['e2e'][k], ref[k]):.1e} "
                          f"({_rel(control[k], ref[k]):.1e})"
                          for k in sorted(ref)))
    else:
        print(f"\n{world} ranks, {inputs}, fused={fused}: end to end, of "
              "each key's scale (oneDNN on; off): " + ", ".join(
                  f"{k} {_rel(g['e2e'][k], ref[k]):.1e}; "
                  f"{_rel(g['e2e_gemm'][k], base[k]):.1e}"
                  for k in sorted(ref)))
    assert float(ref["traversability_preds"].abs().max()) > 0.1  # alive


@pytest.mark.parametrize("inputs", ["identity"] + [
    f"camera-{v}" for v in JAX_VARIANTS])
def test_graph_matches_jax_sharded(tiny, ranks, inputs):
    """The 4-rank graph from JAX's sharded graph's inputs to each stage,
    against that graph: in f32 (``identity``, and ``fold_bn`` under JAX's
    ``folded_inference_bn``) the keys of ``JAX_KEYS`` at JAX's atol
    ``GRAPH_TOL`` from JAX's backbone outputs, and the unfused reward from
    JAX's input view (of the key's scale on the camera's frame); in bf16
    each stage at ``_stage_bar``. End to end in
    f32 at the parity bar, in bf16 at ``_bf16_frame_bar``."""
    jout = tiny["jout"][inputs]
    job = tiny["jobs"][inputs]
    # JAX's own atol on the identity frame, whose grid lies below 1; the
    # camera's densities reach ~73, where f32's spacing alone is 7.6e-06,
    # so there the bar is of the key's scale, as against the one-rank graph
    hold = _close if inputs == "identity" else _scaled
    for r, res in enumerate(ranks[4]):
        for fused in (False, True):
            g = res["graphs"][inputs, fused]
            st = g["jax_stages"]
            if not is_bf16(job):
                for k in JAX_KEYS:
                    hold(st["splat"][k], jout[k], GRAPH_TOL,
                         f"rank {r} {k} from JAX's backbone outputs")
                for k in REWARD_KEYS:
                    hold(st["reward"][k], jout[k], GRAPH_TOL,
                         f"rank {r} {k} from JAX's input view")
            else:
                for stage, keys in _stages(jout, st).items():
                    for k in keys:
                        _scaled(st[stage][k], jout[k],
                                _stage_bar(job, stage, k),
                                f"rank {r} {k} ({stage} stage from JAX's)")
            for k in JAX_KEYS:
                _scaled(g["e2e"][k], jout[k], _bf16_frame_bar(k)
                        if is_bf16(job) else PARITY_BAR,
                        f"rank {r} {k} end to end")
    one = tiny["refs"][inputs, False]
    four = ranks[4][0]["graphs"][inputs, False]["e2e"]
    print(f"\n{inputs}: end to end from JAX's sharded graph, max|d| (one "
          "rank; 4 ranks; of the key's scale on 4 ranks): " + ", ".join(
              f"{k} {np.abs(one[k].float().numpy() - jout[k].float().numpy()).max():.1e}; "
              f"{np.abs(four[k].float().numpy() - jout[k].float().numpy()).max():.1e}; "
              f"{_rel(four[k], jout[k]):.1e}"
              for k in JAX_KEYS))
    assert float(jout["traversability_preds"].abs().max()) > 0.1
    assert float(jout["bev_densities"].max()) > 0  # the splat hit the grid


def test_a_rank_owns_no_column(tiny):
    """At the tiny preset on 4 ranks the trunk's deepest maps are narrower
    than the mesh: a rank owns none of their columns (and the graph
    tests above still hold)."""
    trunk = tiny["model"].backbone.depthcomp.depthcomp.vision_backbone\
        .effnet.trunk
    x = torch.zeros(1, 4, *tiny["cfg"]["vision_backbone"]["vision_backbone"][
        "effnet_cfgs"]["image_size"])
    with torch.no_grad():
        widths = [e.shape[-1] for e in trunk(x).values()]
    assert min(widths) < 4
    assert sp.partition(min(widths), 4)[-1] == (min(widths), min(widths))


def test_spatial_mesh_rejects_more_ranks(ranks):
    with pytest.raises(ValueError, match="spatial mesh needs"):
        make_spatial_mesh(2)  # one process, no group
    for world in WORLDS:
        for r, res in enumerate(ranks[world]):
            assert res["mesh"] == (world, r)
            assert res["too_many"] is not None
            assert res["too_many"].startswith(
                f"spatial mesh needs {world + 1} ranks, have {world}")


def test_spatial_mesh_over_fewer_ranks(tiny, ranks):
    """``make_spatial_mesh(1)`` in a group of 2 or 4 ranks: a mesh of rank
    0 alone, whose graph is the one-rank graph; the other ranks are not
    its members and their graph refuses to build."""
    name = next(iter(tiny["jobs"]))
    for world in WORLDS:
        for r, res in enumerate(ranks[world]):
            if r == 0:
                assert res["sub"] == (1, 0)
                _scaled(res["sub_reward"], tiny["refs"][name, True][
                    "traversability_preds"], PARITY_BAR, "rank 0 alone")
            else:
                assert res["sub"] == (1, -1)
                assert "not a member" in res["sub_reward"]


def test_output_keys_gathers_only_those(tiny, ranks):
    """``output_keys`` the reward alone, on 2 and 4 ranks: every rank
    returns that key only, equal to the bit to the reward of the frame
    that gathers every output."""
    name = next(iter(tiny["jobs"]))
    for world in WORLDS:
        for r, res in enumerate(ranks[world]):
            assert list(res["reward_only"]) == ["traversability_preds"], r
            assert torch.equal(
                res["reward_only"]["traversability_preds"],
                res["graphs"][name, True]["e2e"]["traversability_preds"]), r


def test_shardings_name_the_columns():
    """Weights and p2p replicated, the RGBD width split as GSPMD splits
    it: 612 columns over 4 ranks are 153 each, 3 over 4 leave the last
    rank none."""
    assert SPATIAL_AXIS == "x"
    mesh = sp.SpatialMesh(None, 4, 2)
    weights, rgbd, p2p = spatial_inference_shardings(mesh, 612)
    assert rgbd.axis == 3
    assert rgbd.ranges == ((0, 153), (153, 306), (306, 459), (459, 612))
    x = torch.arange(612.0).reshape(1, 1, 1, 612, 1)
    assert torch.equal(rgbd.shard(x, mesh).flatten(),
                       torch.arange(306.0, 459.0))
    assert weights.shard(x, mesh) is x and p2p.shard(x, mesh) is x
    assert sp.partition(3, 4) == [(0, 1), (1, 2), (2, 3), (3, 3)]
    assert sp.partition(77, 2) == [(0, 39), (39, 77)]


@pytest.mark.parametrize("world", (2, 3, 4))
@pytest.mark.parametrize("width", (16, 128, 130))
def test_head_strips_cover_the_receptive_field(width, world):
    """Each rank's strip of the reward head's input view starts and ends
    on an even column and reaches HEAD_HALO columns past its own, but
    for the frame's edges."""
    for r in range(world):
        mesh = sp.SpatialMesh(None, world, r)
        a, b = mesh.columns(width)
        s, e = sp.head_strip_columns(width, mesh)[r]
        assert s % 2 == 0 and e % 2 == 0 and 0 <= s <= a and b <= e <= width
        assert s == 0 or a - s >= sp.HEAD_HALO
        assert e == width or e - b >= sp.HEAD_HALO
    with pytest.raises(ValueError, match="even"):
        sp.head_strip_columns(width + 1, sp.SpatialMesh(None, world, 0))


def test_entry_point_runs_on_the_card_unless_asked(tiny):
    """``build_spatial_inference_fn`` defaults to the card, as the port's
    other entry points do; on a machine without one it raises unless the
    caller asks for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    graph = variant_graph(tiny["jobs"]["camera"], True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_spatial_inference_fn(graph, make_spatial_mesh())
    fn = build_spatial_inference_fn(graph, make_spatial_mesh(),
                                    device="cpu")
    rgbd, p2p = _inputs("camera", *tiny["cfg"]["vision_backbone"][
        "vision_backbone"]["effnet_cfgs"]["image_size"])
    out = fn(rgbd, p2p)
    ref = tiny["refs"]["camera", True]
    assert sorted(out) == sorted(ref)
    for k in ref:
        _scaled(out[k], ref[k], PARITY_BAR, k)


def _refused_graph(cfg: dict, what: str):
    """An ``InferenceGraph`` the split graph refuses (random weights):
    with the temporal merge (the JAX package's temporal-training layer,
    the decoder on its merged features), with stage 1's PE map in its
    backbone, or in training mode (set after the entry point was
    built)."""
    cfg = copy.deepcopy(cfg)
    vb = cfg["vision_backbone"]
    if what == "temporal":
        dims = vb["camera_projector"]["vision_fusion"]["dims"][-1]
        vb["use_temporal"] = True
        vb["temporal_layer"] = {"net_kwargs": {
            "rnn_input_channels": dims,
            "rnn_config": {"hidden_dims": [dims], "groups": 1,
                           "cell_type": "GRU", "kernel_size": [1, 1],
                           "use_pose": False, "noisy_pose": False}}}
        vb["bev_classifier"]["net_kwargs"]["input_key"] = (
            "merged_bev_features")
    elif what == "stage1":
        h, w = vb["vision_backbone"]["effnet_cfgs"]["image_size"]
        vb["fdn_embed_dim"] = vb["distillation_head"]["feature_head"][
            "dims"][-1]
        vb["pe_map"] = {"height": h // 8, "width": w // 8,
                        "use_norm": False}
    return build_inference_graph(cfg, MaxEntIRL(cfg).state_dict(), "cpu")


@pytest.mark.parametrize("what", ("temporal", "stage1", "training"))
def test_refuses_the_variants_it_does_not_split(tiny, what):
    """What the split graph refuses, with the reason in the message: the
    temporal merge (no inference config runs it), stage 1's branches of
    the backbone (no deployment graph runs them) and training mode; every
    serving variant runs (``test_graph_matches_one_rank``)."""
    graph = _refused_graph(tiny["cfg"], what)
    fn = build_spatial_inference_fn(graph, make_spatial_mesh(),
                                    device="cpu")
    if what == "training":
        graph.model.train()
    rgbd, p2p = _inputs("camera", *tiny["cfg"]["vision_backbone"][
        "vision_backbone"]["effnet_cfgs"]["image_size"])
    match = {"temporal": "temporal merge", "stage1": "stage 1",
             "training": "training mode"}[what]
    with pytest.raises(NotImplementedError, match=match):
        fn(rgbd, p2p)


def test_variant_comes_from_the_graph(tiny):
    """``build_spatial_inference_fn`` reads the variant from its
    ``InferenceGraph``: a bf16 + ``fold_bn`` graph runs its bf16 stream
    and its f32 head, the graph's own folded tensors (on one rank the
    reward is the operator's on the whole input view, to the bit)."""
    job = tiny["jobs"]["camera-bf16_fold_bn"]
    fused = variant_graph(job, True)
    fn = build_spatial_inference_fn(fused, make_spatial_mesh(),
                                    device="cpu")
    out = fn(job["rgbd"], job["p2p"])
    assert out["bev_features"].dtype == torch.bfloat16
    assert out["traversability_preds"].dtype == torch.float32
    assert all(m.folded for m in fused.modules() if hasattr(m, "folded"))
    want = torch.ops.creste.msfcn_head(out["input_view"].contiguous(),
                                       fused.head_tensors())
    assert torch.equal(out["traversability_preds"], want)
