"""The port's deployment graph (runtime/export.build_inference_fn) against
the JAX package's, at the tiny preset on the CPU, plus one slow case at the
production shape [1,1,512,612,4].

The JAX side is build_inference_fn(fused_reward=True) (the Pallas head in
interpret mode) and the flax MaxEntIRL.apply(train=False); the port takes
the same weights through from_jax_variables. Tolerance: rtol 1e-3,
atol 1e-3, the whole-graph bar of docs/PARITY.md (f32 through ~60 layers and
a scatter, sums in other orders); the reward itself agrees to ~1e-5.
"""
import jax
import numpy as np
import pytest
import torch

from creste_public_tpu.config import presets as jpresets
from creste_public_tpu.models.lfd import MaxEntIRL as JMaxEntIRL
from creste_public_tpu.runtime.export import build_inference_fn as jbuild
from creste_public_tpu_torch.config import presets
from creste_public_tpu_torch.models.lfd import MaxEntIRL
from creste_public_tpu_torch.runtime.export import build_inference_fn
from creste_public_tpu_torch.weights import from_jax_variables
from tests.test_torch_helpers import flat_variables, jax_variables, jitter_bn

KEYS = ("traversability_preds", "traversability_preds_full", "input_view",
        "depth_preds_metric", "bev_features", "inpainting_sam_preds",
        "inpainting_sam_dynamic_preds", "elevation_preds")


def _inputs(h, w, depth_mm):
    rng = np.random.default_rng(0)
    rgbd = rng.uniform(0, 1, (1, 1, h, w, 4)).astype(np.float32)
    rgbd[..., 3] *= depth_mm
    fx = fy = 0.9 * w
    kinv = np.array([[1 / fx, 0, -w / 2 / fx], [0, 1 / fy, -h / 2 / fy],
                     [0, 0, 1.0]])
    rot = np.array([[0, 0, 1.0], [-1, 0, 0], [0, -1, 0]])
    p2p = np.eye(4, dtype=np.float32)
    p2p[:3, :3] = (rot @ kinv).astype(np.float32)
    return rgbd, p2p[None, None]


def _graphs(cfg, depth_mm):
    cfg = dict(cfg, solve_mdp=False)
    h, w = cfg["vision_backbone"]["vision_backbone"]["effnet_cfgs"][
        "image_size"]
    rgbd, p2p = _inputs(h, w, depth_mm)
    jm = JMaxEntIRL(cfg)
    flat = jitter_bn(flat_variables(
        jm.init({"params": jax.random.PRNGKey(0)}, rgbd, p2p)))
    jv = jax_variables(flat)
    return cfg, rgbd, p2p, jm, jv, flat


@pytest.fixture(scope="module")
def tiny():
    cfg, rgbd, p2p, jm, jv, flat = _graphs(
        jpresets.tiny_traversability_config().to_dict(), 3000.0)
    ref_flax = jm.apply(jv, rgbd, p2p, train=False)
    jfn, _ = jbuild(cfg, jv, fused_reward=True)
    ref_fused = jfn(jv, rgbd, p2p)
    return cfg, rgbd, p2p, flat, ref_flax, ref_fused


def _check(out, ref, keys=KEYS):
    for k in keys:
        assert tuple(out[k].shape) == ref[k].shape, k
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-3, atol=1e-3, err_msg=k)


def test_deployment_graph_matches_jax_fused(tiny):
    cfg, rgbd, p2p, flat, ref_flax, ref_fused = tiny
    out = build_inference_fn(cfg, from_jax_variables(flat), device="cpu")(
        rgbd, p2p)
    _check(out, ref_fused)
    assert float(out["bev_densities"].sum()) > 0  # the splat hit the grid
    for k in ("traversability_preds", "traversability_preds_full"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref_fused[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def test_deployment_graph_matches_flax_apply(tiny):
    cfg, rgbd, p2p, flat, ref_flax, _ = tiny
    out = build_inference_fn(cfg, from_jax_variables(flat), device="cpu")(
        torch.from_numpy(rgbd), torch.from_numpy(p2p))
    _check(out, ref_flax)
    assert sorted(out) == sorted(ref_flax)


def test_unfused_module_matches_flax_apply(tiny):
    """MaxEntIRL.forward (the VIN head on the unfused MultiScaleFCN)."""
    cfg, rgbd, p2p, flat, ref_flax, _ = tiny
    m = MaxEntIRL(cfg)
    m.load_state_dict(from_jax_variables(flat), strict=True)
    with torch.no_grad():
        out = m.eval()(torch.from_numpy(rgbd), torch.from_numpy(p2p))
    _check(out, ref_flax)


def test_tiny_presets_match_config_shapes():
    cfg = presets.tiny_traversability_config().to_dict()
    cfg["solve_mdp"] = True
    with pytest.raises(NotImplementedError):
        MaxEntIRL(cfg)


def _rel(got, ref) -> float:
    """max|d| / max(1, max|ref|)."""
    ref = np.asarray(ref, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - ref).max()
                 / max(1.0, np.abs(ref).max()))


@pytest.mark.slow
def test_production_shape_matches_jax_fused():
    """traversability_model_config at RGBD [1,1,512,612,4] (the splat then
    takes 128*153 = 19,584 points per frame), held stage by stage.

    The backbone is held to 1e-4 of its scale (metric depth 1e-3). Each
    later stage runs from the JAX graph's own input to that stage and is
    held to 1e-4. End to end the graph is held to 1e-2 only: with random
    weights the depth logits reach ~350, so the ~3e-6 relative difference
    of the backbone becomes mm-scale shifts of the softmax-expectation
    depth (and flips of its argmax bins), which move the splat weights;
    the reward then differs by ~2e-3 of its scale.
    """
    cfg, rgbd, p2p, jm, jv, flat = _graphs(
        jpresets.traversability_model_config().to_dict(), 20000.0)
    jfn, _ = jbuild(cfg, jv, fused_reward=True)
    ref = jfn(jv, rgbd, p2p)
    state = from_jax_variables(flat)
    out = build_inference_fn(cfg, state, device="cpu")(rgbd, p2p)
    assert out["traversability_preds"].shape == (1, 64, 128, 1)
    assert out["traversability_preds_full"].shape == (1, 256, 256, 1)
    for k in ("depth_preds_feats", "depth_preds_logits", "dino_pe_feats"):
        assert _rel(out[k], ref[k]) <= 1e-4, k
    assert _rel(out["depth_preds_metric"], ref["depth_preds_metric"]) <= 1e-3
    for k in ref:
        if k != "depth_preds_bins":
            assert _rel(out[k], ref[k]) <= 1e-2, k

    m = MaxEntIRL(cfg)
    m.load_state_dict(state, strict=True)
    r = {k: torch.from_numpy(np.array(v, np.float32)) for k, v in ref.items()}
    with torch.no_grad():
        stages = dict(m.eval().backbone.cam2map(
            r["depth_preds_metric"].reshape(1, 1, 128, 153),
            r["depth_preds_feats"].reshape(1, 1, 128, 153, 256),
            torch.from_numpy(p2p)))
        stages.update(m.backbone.bevclassifier(r))
        stages.update(m.traversability_head(r))
    for k, v in stages.items():
        assert _rel(v, ref[k]) <= 1e-4, k
