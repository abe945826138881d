"""The port's BEV decoder options against the JAX package's on the CPU:
``merged_heads`` (the N DeconvHeads as one block-diagonal conv chain),
``merge_decoder_heads`` (the state-dict rewrite, the JAX package's
``merge_decoder_head_variables`` / ``merge_heads_in_variables``),
``learnable_loss_weight`` (a zero-initialised ``log_var`` per decoder that
the losses read through ``logvar_key``) and ``key_suffix``; and the weight
map's round trip over a flax tree with ``temporal_layer``, ``mh_*`` and
``log_var``.

Weights: a seeded flax-shaped tree with every BatchNorm jittered (so the
BN merge does real work), inputs seeded normals. Tolerances: the merged
decoder against the per-head one in the port to MERGE_RTOL = 1e-6 of each
output's largest entry (grouped against separate convolutions: f32 sums in
another order); each port decoder against its JAX counterpart to
DECODER_RTOL = 1e-5 (the same layers on both sides; the JAX package's own
merged-vs-per-head test holds 2e-5 absolute); the rewrite's tensors
bit-equal to the JAX rewrite's mapped ones.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from creste_public_tpu.losses import manager as jmanager
from creste_public_tpu.models.blocks.resnet import (
    InpaintingResNet18MultiHead as JDecoder,
)
from creste_public_tpu.models.blocks.resnet import (
    merge_decoder_head_variables,
    merge_heads_in_variables,
)
from creste_public_tpu.models.terrainnet import TerrainNet as JTerrainNet
from creste_public_tpu_torch.config.groups import GROUPS
from creste_public_tpu_torch.losses import manager
from creste_public_tpu_torch.models.blocks.resnet import (
    InpaintingResNet18MultiHead,
    merge_decoder_heads,
)
from creste_public_tpu_torch.models.terrainnet import TerrainNet
from creste_public_tpu_torch.weights import from_jax_variables
from tests.test_torch_helpers import jax_variables, jitter_bn, seeded_variables
from tests.test_torch_step_helpers import (
    one_torch_thread,  # noqa: F401 (an autouse fixture)
    rel,
)

MERGE_RTOL = 1e-6
DECODER_RTOL = 1e-5
NUM_CLASSES = (7, 3, 2)
PREFIXES = ("inpainting_sam", "inpainting_sem", "elevation")


def _jdec(merged, llw):
    return JDecoder(num_classes=NUM_CLASSES, output_prefix=PREFIXES,
                    learnable_loss_weight=llw, merged_heads=merged)


def _tdec(merged, llw, cin=16):
    return InpaintingResNet18MultiHead(cin, NUM_CLASSES, PREFIXES,
                                       learnable_loss_weight=llw,
                                       merged_heads=merged)


def _flat(tree) -> dict[str, np.ndarray]:
    return {k: np.asarray(v) for k, v in flatten_dict(tree, sep="/").items()}


@pytest.fixture(scope="module")
def dec_run():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 32, 40, 16)).astype(np.float32)
    td = {"bev_features": jnp.asarray(x)}
    # the JAX decoders with the learnable weight (the heads' numbers are
    # the same without it: that case drops log_var and log_variance)
    base = _jdec(False, True)
    fl = jitter_bn(seeded_variables(base, td, seed=3))
    fl["params/log_var"] = np.asarray([0.3], np.float32)
    vs = jax_variables(fl)
    ref = jax.jit(base.apply)(vs, td)
    mp, ms = merge_decoder_head_variables(vs["params"], vs["batch_stats"],
                                          NUM_CLASSES)
    got = jax.jit(_jdec(True, True).apply)({"params": mp,
                                            "batch_stats": ms}, td)
    run = dict(flat=fl, merged_flat=dict(
        **{f"params/{k}": v for k, v in _flat(mp).items()},
        **{f"batch_stats/{k}": v for k, v in _flat(ms).items()}),
        ref=jax.tree_util.tree_map(np.asarray, ref),
        merged=jax.tree_util.tree_map(np.asarray, got))
    plain = {k: {kk: vv for kk, vv in v.items() if "log_var" not in kk}
             for k, v in run.items()}
    return dict(x=x, runs={True: run, False: plain})


@pytest.mark.parametrize("llw", [False, True])
def test_merged_heads_match_per_head(dec_run, llw):
    """Per-head and merged decoders (eval) from the same weights: the
    port's per-head one against JAX's, the port's merged one (its own
    rewrite) against the port's per-head one and against JAX's merged one,
    and ``log_variance`` passed through."""
    run = dec_run["runs"][llw]
    td = {"bev_features": torch.from_numpy(dec_run["x"])}
    per = _tdec(False, llw)
    per.load_state_dict(from_jax_variables(run["flat"]), strict=True)
    per.eval()
    merged = _tdec(True, llw)
    merged.load_state_dict(merge_decoder_heads(per.state_dict(),
                                               NUM_CLASSES), strict=True)
    merged.eval()
    with torch.no_grad():
        a, b = per(td), merged(td)
    assert a.keys() == b.keys() == run["ref"].keys()
    for k, ref in run["ref"].items():
        assert rel(a[k], ref) <= DECODER_RTOL, k
        assert rel(b[k], a[k].detach().numpy()) <= MERGE_RTOL, k
        assert rel(b[k], run["merged"][k]) <= DECODER_RTOL, k
    if llw:
        assert float(b["log_variance"].detach()) == pytest.approx(0.3)
        assert ("log_var" in dict(merged.named_parameters()))
    merged.train()
    with pytest.raises(RuntimeError, match="inference-only"):
        merged(td)


@pytest.mark.parametrize("llw", [False, True])
def test_merge_rewrite_matches_jax(dec_run, llw):
    """The port's rewrite of a per-head state dict equals the JAX
    package's rewrite of the flax tree mapped by ``from_jax_variables``,
    tensor by tensor and to the bit, with no per-head tensor left; the
    full-model rewrite at a prefix leaves every other key as it was."""
    run = dec_run["runs"][llw]
    per = from_jax_variables(run["flat"])
    got = merge_decoder_heads(per, NUM_CLASSES)
    want = from_jax_variables(run["merged_flat"])
    assert got.keys() == want.keys()
    assert not any(k.startswith("head_") for k in got)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    full = {f"backbone.bevclassifier.{k}": v for k, v in per.items()}
    full["backbone.other.weight"] = torch.ones(3)
    out = merge_decoder_heads(full, NUM_CLASSES, "backbone.bevclassifier.")
    assert torch.equal(out["backbone.other.weight"], torch.ones(3))
    assert "backbone.bevclassifier.mh_conv0.weight" in out
    assert "backbone.bevclassifier.head_0.proj.weight" in full
    jfull = {"params": {"backbone": {"bevclassifier": jax_variables(
        run["flat"])["params"]}}, "batch_stats": {"backbone": {
            "bevclassifier": jax_variables(run["flat"])["batch_stats"]}}}
    jout = merge_heads_in_variables(jfull, NUM_CLASSES)
    jmapped = from_jax_variables({
        **{f"params/{k}": v for k, v in _flat(jout["params"]).items()},
        **{f"batch_stats/{k}": v for k, v in _flat(
            jout["batch_stats"]).items()}})
    for k, v in jmapped.items():
        assert torch.equal(out[k], v), k


def test_key_suffix_and_learnable_weight_match_jax(dec_run):
    """The decoder's second (movability) call reads ``bev_features_mv``
    and suffixes only the SAM head's keys, as the JAX decoder does; a loss
    with ``logvar_key`` weighs itself by 1 / (2 exp(log_var)) and adds
    ``log_std``, and both reach the parameter's gradient."""
    run = dec_run["runs"][True]
    x = dec_run["x"]
    jm = _jdec(False, True)
    want = jax.jit(lambda v, t: jm.apply(v, t, key_suffix="_mv"))(
        jax_variables(run["flat"]), {"bev_features_mv": jnp.asarray(x)})
    dec = _tdec(False, True)
    dec.load_state_dict(from_jax_variables(run["flat"]), strict=True)
    dec.eval()
    got = dec({"bev_features_mv": torch.from_numpy(x)}, key_suffix="_mv")
    assert got.keys() == want.keys()
    assert {"inpainting_sam_mv_preds", "inpainting_sem_preds",
            "elevation_preds", "log_variance"} <= set(got)
    for k, ref in want.items():
        assert rel(got[k], np.asarray(ref)) <= DECODER_RTOL, k

    cfg = {"name": "SmoothL1", "weight": 2.0, "beta": 0.3,
           "pred_key": "outputs/elevation_preds",
           "lab_key": "inputs/elevation_label",
           "logvar_key": "outputs/log_variance"}
    lab = np.random.default_rng(1).normal(size=got["elevation_preds"].shape)
    lab = lab.astype(np.float32)

    def jtotal(lv):
        td = {"outputs/elevation_preds": jnp.asarray(
            got["elevation_preds"].detach().numpy()),
              "inputs/elevation_label": jnp.asarray(lab),
              "outputs/log_variance": lv}
        ld, _ = jmanager._REGISTRY["SmoothL1"](cfg)(td)
        # the learned weight has log_var's shape (1,), and so has the
        # total: summed to a scalar on both sides
        return jnp.sum(jmanager.LossManager.total(ld)), ld

    (jt, jld), jg = jax.value_and_grad(jtotal, has_aux=True)(
        jnp.asarray([0.3]))
    td = {"outputs/elevation_preds": got["elevation_preds"].detach(),
          "inputs/elevation_label": torch.from_numpy(lab),
          "outputs/log_variance": got["log_variance"]}
    ld, _ = manager.make_loss(cfg)(td)
    assert ld.keys() == jld.keys() and "log_std" in ld
    total = manager.LossManager.total(ld).sum()
    total.backward()
    np.testing.assert_allclose(float(total.detach()), float(jt), rtol=2e-6)
    np.testing.assert_allclose(dec.log_var.grad.numpy(), np.asarray(jg),
                               rtol=1e-5)


def test_weight_map_round_trip_with_temporal_merged_and_log_var():
    """A flax TerrainNet tree with ``temporal_layer`` (pose, z-MLP),
    merged ``mh_*`` decoder heads and ``log_var`` loads into the port's
    TerrainNet with ``strict=True`` and comes back leaf for leaf: every
    flax leaf maps to exactly one port tensor and back, none left over."""
    cfg = copy.deepcopy(GROUPS["model"]["ssc_sam/tiny"])
    cfg["vision_backbone"]["effnet_cfgs"]["stage_repeats"] = 1
    cfg["use_temporal"] = True
    cfg["temporal_layer"] = {"net_kwargs": {
        "rnn_input_channels": 12, "rnn_config": {
            "hidden_dims": [12], "groups": 2, "kernel_size": [3, 3],
            "use_pose": True, "use_z": False}}}
    kw = dict(cfg["bev_classifier"]["net_kwargs"], merged_heads=True,
              learnable_loss_weight=True, num_input_features=12,
              input_key="merged_bev_features")
    cfg["bev_classifier"] = dict(cfg["bev_classifier"], net_kwargs=kw)
    jm = JTerrainNet(cfg)
    rng = np.random.default_rng(0)
    image = rng.uniform(size=(1, 2, 64, 80, 4)).astype(np.float32)
    p2p = np.tile(np.eye(4, dtype=np.float32), (1, 2, 1, 1))
    pose = np.tile(np.eye(4, dtype=np.float32), (1, 2, 1, 1))
    fl = jitter_bn(seeded_variables(jm, image, p2p, init=lambda r, i, p:
                                    jm.init(r, i, p, None, train=False,
                                            pose=jnp.asarray(pose))))
    fl["params/bevclassifier/log_var"] = np.asarray([0.2], np.float32)
    assert any(k.startswith("params/temporal_layer/rnn/cell_0/") for k in fl)
    assert "params/bevclassifier/mh_proj/kernel" in fl
    model = TerrainNet(cfg)
    sd = from_jax_variables(fl)
    model.load_state_dict(sd, strict=True)
    assert len(sd) == len(fl) == len(model.state_dict())
    back = _to_flax(model.state_dict(), fl)
    assert back.keys() == fl.keys()
    for k, v in fl.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def _to_flax(sd: dict, like: dict) -> dict[str, np.ndarray]:
    """The inverse of ``from_jax_variables``'s rules (test-local): each
    flax key of ``like`` read back from the port's state dict."""
    out = {}
    for key, ref in like.items():
        coll, *path, leaf = key.split("/")
        name = {"kernel": "weight", "scale": "weight", "bias": "bias",
                "mean": "running_mean", "var": "running_var",
                "log_var": "log_var"}[leaf]
        t = sd[".".join([*path, name])].numpy()
        if leaf == "kernel":
            t = t.transpose(2, 3, 1, 0) if t.ndim == 4 else t.T
        out[key] = t.reshape(ref.shape)
    return out
