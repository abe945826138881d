"""Spatial inference on the CPU: one frame's width split across 2 and 4
spawned gloo ranks (``parallel.spatial``, ``runtime.export.
build_spatial_inference_fn``), the rank code in
``tests/test_torch_spatial_ranks.py``.

``test_primitive_matches_unsharded``: each width-sharded primitive
(convolutions at kernels 1, 3, 5 and 7, strides 1 and 2, depthwise,
asymmetric and SAME padding; the 2x2 max-pool; the bilinear resize at the
global sizes; the full-frame mean) at widths 80, 77 and 3, gathered
back, against the op on the whole tensor, to 1e-6 absolute in f32. At
width 3 some ranks own no column of the input or the output.

``test_graph_matches_one_rank``: the tiny deployment graph
(``presets.tiny_traversability_config()``, ``solve_mdp=False``) on 2 and
4 ranks, fused (the folded head's plain version on each rank's padded
strip) and unfused, against the one-rank ``InferenceGraph``, on every
rank, for every output key, to 1e-5 of the key's scale (max|d| over
max(1, max|ref|), chip_smoke's measure), stage by stage from the
one-rank graph's input to each stage: the trunk's features from the
frame, the depth and DINO heads from the trunk's features, the splat from
the metric depth and features, the decoder and the reward from the BEV
grid. These run with oneDNN off on both sides: oneDNN picks its
convolution algorithm by the input's width, so a strip rounds
differently from the frame, where torch's im2col GEMM sums every output
in one order at any width. End to end every key is held to the repo's
1e-3 parity bar of its scale, with oneDNN on and off: the
softmax-expectation depth turns last-bit differences of the logits (the
squeeze-excitation means and the small bilinear resizes round
differently on strips even with oneDNN off) into shifts of the splat's
bilinear weights. ``-s`` prints each key's distance end to end: at the
camera inputs up to 2.1e-05 of the metric depth's scale, 4.9e-04 of
``bev_features``' and 1.4e-04 of the reward's.

``test_graph_matches_jax_sharded``: the 4-rank graph against the JAX
package's ``jit(..., in_shardings=spatial_inference_shardings(
make_spatial_mesh(4)))`` on the virtual CPU devices, on the inputs of
``tests/test_spatial_inference.py``: ``traversability_preds``,
``traversability_preds_full``, ``bev_densities`` and ``elevation_preds``
at JAX's own atol 1e-5 from JAX's backbone outputs, and end to end at the
parity bar: end to end the one-rank graph itself reads 5.3e-05 from JAX's
``bev_densities`` (``-s`` prints it), for the reason above.

``test_spatial_mesh_rejects_more_ranks``: ``make_spatial_mesh(world + 1)``
raises ``ValueError("spatial mesh needs ...")`` in one process and on
every rank. The rest: a mesh over fewer ranks than the group, the
shardings' columns, the reward head's strips, the entry point's device,
and the variants the split graph refuses.
"""
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
from creste_public_tpu_torch.models.lfd import MaxEntIRL
from creste_public_tpu_torch.parallel import (
    SPATIAL_AXIS,
    make_spatial_mesh,
    spatial_inference_shardings,
)
from creste_public_tpu_torch.parallel import spatial as sp
from creste_public_tpu_torch.runtime.export import (
    InferenceGraph,
    build_spatial_inference_fn,
)
from creste_public_tpu_torch.weights import from_jax_variables
from tests.test_torch_helpers import jax_variables, jitter_bn, seeded_variables
from tests.test_torch_spatial_ranks import (
    gemm_convolutions,
    primitive_cases,
    run_ranks,
    unsharded,
)
from tests.test_torch_step_helpers import one_torch_thread  # noqa: F401

WORLDS = (2, 4)
PRIM_ATOL = 1e-6
GRAPH_TOL = 1e-5  # of each key's scale, stage by stage; JAX's atol
PARITY_BAR = 1e-3  # end to end, of each key's scale (docs/PARITY.md)
REWARD_KEYS = ("traversability_preds", "traversability_preds_full")
JAX_KEYS = REWARD_KEYS + ("bev_densities", "elevation_preds")
SPLAT_KEYS = ("bev_features", "bev_densities", "bev_coords")
INPUTS = ("identity", "camera")


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


def _fed(out: dict, B: int, N: int) -> dict:
    """A graph's backbone outputs and BEV grid as the next stages' inputs."""
    depth = torch.as_tensor(np.asarray(out["depth_preds_metric"]))
    feats = torch.as_tensor(np.asarray(out["depth_preds_feats"]))
    return {"depth": depth.reshape(B, N, *depth.shape[1:]).contiguous(),
            "feats": feats.reshape(B, N, *feats.shape[1:]).contiguous(),
            "bev": torch.as_tensor(np.asarray(out["bev_features"]))}


@pytest.fixture(scope="module")
def tiny():
    """The tiny config, one seeded flax tree (BNs jittered) in both
    packages, the one-rank port graphs and JAX's 4-device sharded apply,
    and the ranks' results on 2 and 4 ranks (spawned once each)."""
    cfg = jpresets.tiny_traversability_config().to_dict()
    cfg["solve_mdp"] = False
    h, w = cfg["vision_backbone"]["vision_backbone"]["effnet_cfgs"][
        "image_size"]
    jm = JMaxEntIRL(cfg)
    rgbd0, p2p0 = _inputs("identity", h, w)
    flat = jitter_bn(seeded_variables(jm, jnp.asarray(rgbd0),
                                      jnp.asarray(p2p0)))
    jv = jax_variables(flat)
    jfn = jax.jit(lambda v, r, p: jm.apply(v, r, p, train=False),
                  in_shardings=jspatial_inference_shardings(
                      jmake_spatial_mesh(4)))
    jout = {k: np.asarray(v, np.float32) for k, v in
            jfn(jv, jnp.asarray(rgbd0), jnp.asarray(p2p0)).items()}
    state = from_jax_variables(flat)
    model = MaxEntIRL(cfg)
    model.load_state_dict(state, strict=True)
    model.eval()
    refs, jobs = {}, {}
    for name in INPUTS:
        rgbd, p2p = _inputs(name, h, w)
        with torch.no_grad():
            for fused in (True, False):
                graph = InferenceGraph(model, fused).eval()
                args = torch.from_numpy(rgbd), torch.from_numpy(p2p)
                refs[name, fused] = graph(*args)
                with gemm_convolutions():
                    refs[name, fused, "gemm"] = graph(*args)
        jobs[name] = dict(cfg=cfg, state=state, rgbd=rgbd, p2p=p2p,
                          fed_gemm=_fed(refs[name, True, "gemm"], 1, 1))
    jobs["identity"]["jax_fed"] = _fed(jout, 1, 1)
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
    for r, res in enumerate(ranks[world]):
        got = res["prims"][case["name"]]
        assert got.shape == ref.shape, (r, case["name"])
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                                   atol=PRIM_ATOL,
                                   err_msg=f"rank {r} {case['name']}")


def _close(got, want, atol, msg):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, msg
    np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=msg)


def _rel(got, want) -> float:
    """max|got - want| / max(1, max|want|)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(1.0, float(
        np.abs(want).max()))


def _scaled(got, want, tol, msg):
    """max|got - want| <= tol * max(1, max|want|): ``tol`` of the key's
    scale (chip_smoke's measure)."""
    want = np.asarray(want, np.float64)
    _close(got, want, tol * max(1.0, float(np.abs(want).max())), msg)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("fused", (True, False), ids=("fused", "unfused"))
@pytest.mark.parametrize("inputs", INPUTS)
def test_graph_matches_one_rank(tiny, ranks, world, fused, inputs):
    ref = tiny["refs"][inputs, fused]
    gemm = tiny["refs"][inputs, fused, "gemm"]
    stages = {"e2e_gemm": ("depth_preds_feats",),
              "heads": ("depth_preds_logits", "depth_preds_metric",
                        "depth_preds_bins", "dino_pe_feats"),
              "splat": SPLAT_KEYS}
    stages["bev"] = tuple(set(ref) - {k for v in stages.values() for k in v})
    for r, res in enumerate(ranks[world]):
        g = res["graphs"][inputs, fused]
        assert sorted(g["e2e"]) == sorted(ref) == sorted(g["e2e_gemm"]), r
        for stage, keys in stages.items():
            for k in keys:
                _scaled(g[stage][k], gemm[k], GRAPH_TOL,
                        f"rank {r} {k} ({stage}, oneDNN off)")
        for k in ref:
            _scaled(g["e2e"][k], ref[k], PARITY_BAR,
                    f"rank {r} {k} end to end")
            _scaled(g["e2e_gemm"][k], gemm[k], PARITY_BAR,
                    f"rank {r} {k} end to end, oneDNN off")
    g = ranks[world][0]["graphs"][inputs, fused]
    print(f"\n{world} ranks, {inputs}, fused={fused}: end to end, of each "
          "key's scale (oneDNN on; off): " + ", ".join(
              f"{k} {_rel(g['e2e'][k], ref[k]):.1e}; "
              f"{_rel(g['e2e_gemm'][k], gemm[k]):.1e}" for k in sorted(ref)))
    assert float(ref["traversability_preds"].abs().max()) > 0.1  # alive


def test_graph_matches_jax_sharded(tiny, ranks):
    jout = tiny["jout"]
    for r, res in enumerate(ranks[4]):
        g = res["graphs"]["identity", False]
        for k in JAX_KEYS:
            _close(g["jax_fed"][k], jout[k], GRAPH_TOL,
                   f"rank {r} {k} from JAX's backbone outputs")
            _scaled(g["e2e"][k], jout[k], PARITY_BAR,
                    f"rank {r} {k} end to end")
        # the fused head's plain version on each rank's padded strip
        f = res["graphs"]["identity", True]
        for k in REWARD_KEYS:
            _close(f["jax_fed"][k], jout[k], GRAPH_TOL, f"rank {r} {k}")
    one = tiny["refs"]["identity", False]
    four = ranks[4][0]["graphs"]["identity", False]["e2e"]
    print("\nend to end from JAX's sharded apply, max|d| (one rank; 4 "
          "ranks): " + ", ".join(
              f"{k} {np.abs(one[k].numpy() - jout[k]).max():.1e}; "
              f"{np.abs(four[k].numpy() - jout[k]).max():.1e}"
              for k in JAX_KEYS))
    assert float(np.abs(jout["traversability_preds"]).max()) > 0.1
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
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_spatial_inference_fn(tiny["model"], make_spatial_mesh())
    fn = build_spatial_inference_fn(tiny["model"], make_spatial_mesh(),
                                    device="cpu")
    rgbd, p2p = _inputs("camera", *tiny["cfg"]["vision_backbone"][
        "vision_backbone"]["effnet_cfgs"]["image_size"])
    out = fn(rgbd, p2p)
    ref = tiny["refs"]["camera", True]
    assert sorted(out) == sorted(ref)
    for k in ref:
        _scaled(out[k], ref[k], PARITY_BAR, k)


@pytest.mark.parametrize("variant", ("merged_heads", "bfloat16"))
def test_refuses_the_variants_it_does_not_split(tiny, variant):
    """The merged-heads decoder and the bf16 stream are serving variants
    of the one-rank graph only: the split graph refuses them."""
    cfg = dict(tiny["cfg"])
    if variant == "merged_heads":
        cfg["vision_backbone"] = dict(cfg["vision_backbone"])
        bev = dict(cfg["vision_backbone"]["bev_classifier"])
        bev["net_kwargs"] = dict(bev["net_kwargs"], merged_heads=True)
        cfg["vision_backbone"]["bev_classifier"] = bev
    else:
        cfg["compute_dtype"] = variant
    fn = build_spatial_inference_fn(MaxEntIRL(cfg), make_spatial_mesh(),
                                    device="cpu")
    rgbd, p2p = _inputs("camera", *cfg["vision_backbone"][
        "vision_backbone"]["effnet_cfgs"]["image_size"])
    with pytest.raises(NotImplementedError, match="spatial inference"):
        fn(rgbd, p2p)
