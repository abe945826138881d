"""The port's movability double-forward against the JAX package's on the
CPU: TerrainNet with ``use_movability`` in training splats the anchor
view, then every view with the movability mask (``*_mv``), and runs the
decoder twice, plain and with ``key_suffix="_mv"``; the seven losses (the
six of the stage-2 preset and a VicregLoss on ``bev_features`` against
``bev_features_mv``, configured as the JAX package's
``tests/test_secondary_models.py`` configures it).

Setup: ``model=ssc_sam/tiny`` with the trunk at ``stage_repeats=1`` (the
branch is after the backbone, whose gradient ``tests/test_torch_ssc_step.py``
holds with drop-connect), B=2 of ``synthetic_tiny`` with its ``mv_mask``,
seeded flax-shaped weights with every BatchNorm jittered, SupCon's and
VICReg's priorities fed to both sides (a test-local ``jax.random.uniform``
returns them by shape). One jitted JAX function gives the train-mode
forward, its running statistics, the losses, and each stage's VJP.

Tolerances, as ``tests/test_torch_ssc_step.py`` sets them for the same
model: the port's own train-mode forward to STAGE_RTOL = 1e-3 of each
map's largest entry (f32 drift through the backbone, splat and decoder);
the losses and metrics of the port's step from the same state to
METRIC_RTOL = 1e-4; the running statistics after the step to STAT_RTOL =
1e-4 (DECODER_STAT_RTOL = 1e-3 for the decoder, downstream of that drift);
each branch stage's gradient from JAX's input to it and JAX's cotangent
at its output: the splat's two calls per tensor to GRAD_RTOL = 1e-4 (of
the larger of the tensor's largest entry and 1e-2 of the stage's), with
the cotangent they pass back into the backbone (the sum over both calls;
the backbone's own gradient from a cotangent is the stage-2 backbone's,
held in ``tests/test_torch_ssc_step.py``), the decoder's two calls by
module to DECODER_MODULE_RTOL = 5e-3 (ReLU kinks that f32 rounding flips
at this size). The control: the decoder's statistics after only one of
its two updates land above DECODER_STAT_RTOL.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from creste_public_tpu.losses import LossManager as JLossManager
from creste_public_tpu.models.blocks.resnet import (
    InpaintingResNet18MultiHead as JDecoder,
)
from creste_public_tpu.models.blocks.splat import Camera2MapMulti as JSplat
from creste_public_tpu.models.terrainnet import TerrainNet as JTerrainNet
from creste_public_tpu.training import pipelines as jpipelines
from creste_public_tpu_torch.config.groups import GROUPS
from creste_public_tpu_torch.models.blocks.convnets import (
    BatchNorm,
    discard_batch_stats,
)
from creste_public_tpu_torch.models.terrainnet import TerrainNet
from creste_public_tpu_torch.training import pipelines
from creste_public_tpu_torch.training.loop import to_device
from creste_public_tpu_torch.weights import from_jax_variables
from tests.test_torch_helpers import jax_variables, jitter_bn, seeded_variables
from tests.test_torch_step_helpers import (
    one_torch_thread,  # noqa: F401 (an autouse fixture)
    flat,
    grad_gaps,
    module_gaps,
    rel,
    tiny_batches,
)

STAGE_RTOL = 1e-3
METRIC_RTOL = 1e-4
STAT_RTOL = 1e-4
DECODER_STAT_RTOL = 1e-3
GRAD_RTOL = 1e-4
DECODER_MODULE_RTOL = 5e-3
CPU = torch.device("cpu")
KEYS = ("image", "p2p", "mv_mask", "depth_label", "fimg_label", "fov_mask",
        "3d_sam_label", "3d_sam_dynamic_label", "elevation_label")
# the decoder outputs the losses read after the two calls: the plain SAM
# head, the others from the masked call (their keys carry no suffix)
HEADS = ("inpainting_sam_preds", "inpainting_sam_dynamic_preds",
         "elevation_preds")
LOSS_INPUTS = HEADS + ("bev_features", "bev_features_mv")
VICREG = {"name": "VicregLoss", "weight": 1.0,
          "pred_key": "outputs/bev_features",
          "pred_mv_key": "outputs/bev_features_mv",
          "lab_key": "inputs/3d_sam_label"}


def movability_cfg() -> dict:
    cfg = copy.deepcopy(GROUPS["model"]["ssc_sam/tiny"])
    cfg["vision_backbone"]["effnet_cfgs"]["stage_repeats"] = 1
    cfg["use_movability"] = True
    cfg["loss"] = list(cfg["loss"]) + [dict(VICREG)]
    return cfg


def _port_sd(tree: dict) -> dict:
    return from_jax_variables(dict(flat(tree["params"], "params"),
                                   **flat(tree["batch_stats"],
                                          "batch_stats")))


@pytest.fixture(scope="module")
def mv_run():
    cfg = movability_cfg()
    batch = tiny_batches(KEYS, n=1)[0]
    jm = JTerrainNet(cfg)
    fl = jitter_bn(seeded_variables(jm, batch["image"], batch["p2p"]))
    variables = jax_variables(fl)
    params, stats = variables["params"], variables["batch_stats"]
    B = batch["image"].shape[0]
    g = batch["fov_mask"].shape[-1]
    rng = np.random.default_rng(8)
    pri = rng.uniform(size=B * g * g).astype(np.float32)
    pairs = rng.uniform(size=g * g).astype(np.float32)
    key = jax.random.PRNGKey(0)
    lm = JLossManager(cfg)
    splat = JSplat(cfg["camera_projector"], scatter_mode="mean")
    kw = cfg["bev_classifier"]["net_kwargs"]
    decoder = JDecoder(num_classes=tuple(kw["num_classes"]),
                       output_prefix=tuple(kw["output_prefix"]))

    def run(module, p, s, *args, **kwargs):
        out, mut = module.apply({"params": p, "batch_stats": s}, *args,
                                train=True, mutable=["batch_stats"],
                                **kwargs)
        return out, mut["batch_stats"]

    def decode(p, s, bev, bev_mv):
        """The decoder's two calls, the second on the statistics the first
        updated (as flax's two calls in one apply)."""
        o1, s1 = run(decoder, p, s, {"bev_features": bev})
        o2, s2 = run(decoder, p, s1, {"bev_features_mv": bev_mv},
                     key_suffix="_mv")
        return dict(o1, **o2), s2, s1

    def cam(p, s, depth, feats, p2p, mv):
        o1, s1 = run(splat, p, s, depth[:, 0:1], feats[:, 0:1],
                     p2p[:, 0:1])
        o2, s2 = run(splat, p, s1, depth, feats, p2p, mv_mask=mv)
        return dict(o1, **o2), s2

    @jax.jit
    def jax_side(params, stats, batch):
        image, p2p, mv = batch["image"], batch["p2p"], batch["mv_mask"]
        out, mut = run(jm, params, stats, image, p2p, mv)
        td = jpipelines.merge_tensor_dict(batch, out, "joint")
        ld, meta = lm(td, {"rng": key})
        metrics = {k: w * v for k, (w, v) in ld.items()}
        metrics.update({k: v for k, v in meta.items() if jnp.ndim(v) == 0})
        metrics["loss"] = JLossManager.total(ld)

        def total(sub):
            t = jpipelines.merge_tensor_dict(batch, dict(out, **sub), "joint")
            return JLossManager.total(lm(t, {"rng": key})[0])

        cot = jax.grad(total)({k: out[k] for k in LOSS_INPUTS})
        # the stages from the forward's own inputs to them
        Hs, Ws = out["depth_preds_metric"].shape[1:]
        depth = out["depth_preds_metric"].reshape(B, 1, Hs, Ws)
        feats = out["depth_preds_feats"].reshape(B, 1, Hs, Ws, -1)
        def heads(p, a, b_):
            o, _, once = decode(p, stats["bevclassifier"], a, b_)
            return {k: o[k] for k in HEADS}, once

        _, dec_vjp, once = jax.vjp(heads, params["bevclassifier"],
                                   out["bev_features"],
                                   out["bev_features_mv"], has_aux=True)
        g_dec, cot_bev, cot_bev_mv = dec_vjp({k: cot[k] for k in HEADS})
        cot_bev = cot_bev + cot["bev_features"]
        cot_bev_mv = cot_bev_mv + cot["bev_features_mv"]
        _, cam_vjp = jax.vjp(
            lambda p, d, f: {k: cam(p, stats["cam2map"], d, f, p2p, mv)[0][k]
                             for k in ("bev_features", "bev_features_mv")},
            params["cam2map"], depth, feats)
        g_cam, cot_depth, cot_feats = cam_vjp(
            {"bev_features": cot_bev, "bev_features_mv": cot_bev_mv})
        return dict(out=out, stats=mut, metrics=metrics, cot=cot,
                    cot_bev=cot_bev, cot_bev_mv=cot_bev_mv,
                    cot_depth=cot_depth, cot_feats=cot_feats,
                    depth=depth, feats=feats,
                    grads={"cam2map": g_cam, "bevclassifier": g_dec},
                    decoder_once=once)

    def uniform(k, shape, *args, **kwargs):
        return jnp.asarray({pri.shape: pri, pairs.shape: pairs}[tuple(shape)])

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "uniform", uniform)
        res = jax.tree_util.tree_map(np.array, jax_side(
            params, stats, {k: jnp.asarray(v) for k, v in batch.items()}))
    prio = {"rng": torch.from_numpy(pri),
            "vicreg_rng": (torch.from_numpy(np.tile(pairs, (B, 1))),
                           torch.from_numpy(pri))}
    return dict(cfg=cfg, batch=batch, flat=fl, prio=prio, **res)


def _port(run):
    model, lm, state = pipelines.init_stage("ssc", run["cfg"],
                                            steps_per_epoch=2, device="cpu")
    model.load_state_dict(from_jax_variables(run["flat"]), strict=True)
    return model, lm, state


def test_movability_forward_matches_jax(mv_run):
    """The port's train-mode forward: every output, the masked splat's
    keys and the ``_mv`` SAM head among them, and the running statistics
    staged by the two splat and two decoder calls."""
    run = mv_run
    model, _, _ = _port(run)
    model.train()
    b = to_device(run["batch"], CPU)
    with torch.no_grad():
        out = model(b["image"], b["p2p"], b["mv_mask"])
    assert out.keys() == run["out"].keys()
    for k in ("bev_features_mv", "bev_densities_mv", "bev_coords_mv",
              "inpainting_sam_mv_preds", "inpainting_sam_mv_features"):
        assert k in out
    for k, ref in run["out"].items():
        if k == "depth_preds_bins":  # an argmax: drift moves its ties
            continue
        assert rel(out[k], ref) <= STAGE_RTOL, (k, rel(out[k], ref))
    # the mask zeroes the dynamic pixels' features (they still count in
    # the mean's density): less feature mass than the plain splat
    assert torch.equal(out["bev_densities_mv"], out["bev_densities"])
    assert float(out["bev_features_mv"].abs().sum()) < float(
        out["bev_features"].abs().sum())
    want = _port_sd({"params": {}, "batch_stats": run["stats"]})
    for name, m in model.named_modules():
        if isinstance(m, BatchNorm):
            bar = (DECODER_STAT_RTOL if name.startswith("bevclassifier")
                   else STAT_RTOL)
            for got, leaf in zip(m.staged, ("running_mean", "running_var")):
                assert rel(got, want[f"{name}.{leaf}"].numpy()) <= bar, name


def test_movability_step_matches_jax(mv_run):
    """One training step of the port from the same state with the seven
    losses: every loss and metric, then the running statistics it
    committed (the decoder's and the splat's updated twice); the control,
    the decoder's statistics after one update, lands above the bar."""
    run = mv_run
    model, lm, state = _port(run)
    step = pipelines.make_train_step("ssc", model, lm, task="joint")
    metrics = step(state, to_device(run["batch"], CPU), None,
                   priorities=run["prio"])
    want = dict(run["metrics"])
    assert "VicregLoss/vicreg_loss" in want and "VicregLoss/vicreg/sim" in want
    assert set(metrics) == set(want) | {"grad_norm"}
    for k, ref in want.items():
        np.testing.assert_allclose(float(metrics[k]), float(ref),
                                   rtol=METRIC_RTOL, atol=1e-7, err_msg=k)
    sd = model.state_dict()
    want_s = _port_sd({"params": {}, "batch_stats": run["stats"]})
    once = _port_sd({"params": {}, "batch_stats": {
        "bevclassifier": run["decoder_once"]}})
    worst_once = 0.0
    for k, ref in want_s.items():
        bar = DECODER_STAT_RTOL if k.startswith("bevclassifier") else STAT_RTOL
        assert rel(sd[k], ref.numpy()) <= bar, k
        if k.startswith("bevclassifier"):
            worst_once = max(worst_once, rel(sd[k], once[k].numpy()))
    assert worst_once > DECODER_STAT_RTOL, worst_once


def test_movability_stage_gradients_match_jax(mv_run):
    """Each branch stage's parameter gradient from JAX's input to it and
    JAX's cotangent at its output: the decoder through its two calls, the
    splat through its anchor and masked calls; and the gradients each
    passes back."""
    run = mv_run
    model, _, _ = _port(run)
    model.train()
    want = from_jax_variables(flat(run["grads"], "params"))
    b = to_device(run["batch"], CPU)
    named = dict(model.named_parameters())

    def grads(prefix):
        return {k: p.grad for k, p in named.items() if k.startswith(prefix)}

    # decoder: both calls from JAX's bev_features and bev_features_mv
    bev = torch.from_numpy(run["out"]["bev_features"]).requires_grad_(True)
    bev_mv = torch.from_numpy(run["out"]["bev_features_mv"]).requires_grad_(
        True)
    out = dict(model.bevclassifier({"bev_features": bev}))
    out.update(model.bevclassifier({"bev_features_mv": bev_mv},
                                   key_suffix="_mv"))
    discard_batch_stats(model)
    torch.autograd.backward([out[k] for k in HEADS],
                            [torch.from_numpy(run["cot"][k]) for k in HEADS])
    worst = max(module_gaps(grads("bevclassifier"), {
        k: v for k, v in want.items() if k.startswith("bevclassifier")
    }).items(), key=lambda kv: kv[1])
    assert worst[1] <= DECODER_MODULE_RTOL, worst
    assert rel(bev.grad + torch.from_numpy(run["cot"]["bev_features"]),
               run["cot_bev"]) <= DECODER_MODULE_RTOL
    assert rel(bev_mv.grad + torch.from_numpy(run["cot"]["bev_features_mv"]),
               run["cot_bev_mv"]) <= DECODER_MODULE_RTOL

    # splat: the anchor and the masked call from JAX's depth and features
    depth = torch.from_numpy(run["depth"]).requires_grad_(True)
    feats = torch.from_numpy(run["feats"]).requires_grad_(True)
    out = dict(model.cam2map(depth[:, 0:1], feats[:, 0:1], b["p2p"][:, 0:1]))
    out.update(model.cam2map(depth, feats, b["p2p"], b["mv_mask"]))
    discard_batch_stats(model)
    torch.autograd.backward(
        [out["bev_features"], out["bev_features_mv"]],
        [torch.from_numpy(run["cot_bev"]), torch.from_numpy(
            run["cot_bev_mv"])])
    # per tensor, a conv bias that a train-mode BatchNorm subtracts out
    # (exact gradient 0) against the stage's scale
    for k, d in grad_gaps(grads("cam2map"), {
            k: v for k, v in want.items() if k.startswith("cam2map")}).items():
        assert d <= GRAD_RTOL, (k, d)
    assert rel(depth.grad, run["cot_depth"]) <= GRAD_RTOL
    assert rel(feats.grad, run["cot_feats"]) <= GRAD_RTOL
    assert set(want) == {k for k in named if not k.startswith("depthcomp")}


def test_movability_branch_switches(mv_run):
    """Without a mask the training forward splats the anchor view only and
    decodes once; in eval the plain path runs whatever the switch; without
    ``use_movability`` a mask has no effect."""
    run = mv_run
    model, _, _ = _port(run)
    b = to_device(run["batch"], CPU)
    with torch.no_grad():
        model.train()
        anchor = model(b["image"], b["p2p"])
        discard_batch_stats(model)
        model.eval()
        plain = model(b["image"], b["p2p"], b["mv_mask"])
        cfg = dict(run["cfg"], use_movability=False)
        off = TerrainNet(cfg)
        off.load_state_dict(model.state_dict(), strict=True)
        off.train()
        masked_off = off(b["image"], b["p2p"], b["mv_mask"])
    assert not any(k.endswith("_mv") or "_mv_" in k for k in anchor)
    assert not any(k.endswith("_mv") or "_mv_" in k for k in plain)
    assert not any(k.endswith("_mv") or "_mv_" in k for k in masked_off)
    assert torch.equal(anchor["bev_features"], masked_off["bev_features"])


def test_terrainnet_depth_completion_backbone_matches_flax():
    """TerrainNet on the plain DepthCompletion backbone (the frames folded
    into the batch; the JAX model's other backbone class) in eval: every
    output against the flax model's to STAGE_RTOL."""
    cfg = copy.deepcopy(GROUPS["model"]["ssc_sam/tiny"])
    cfg["vision_backbone"]["effnet_cfgs"]["stage_repeats"] = 1
    cfg["vision_backbone"]["class_name"] = "DepthCompletion"
    batch = tiny_batches(("image", "p2p"), n=1)[0]
    jm = JTerrainNet(cfg)
    fl = jitter_bn(seeded_variables(jm, batch["image"], batch["p2p"]))
    want = jax.jit(jm.apply)(jax_variables(fl), jnp.asarray(batch["image"]),
                             jnp.asarray(batch["p2p"]))
    model = TerrainNet(cfg)
    model.load_state_dict(from_jax_variables(fl), strict=True)
    model.eval()
    b = to_device(batch, CPU)
    with torch.no_grad():
        out = model(b["image"], b["p2p"])
    assert out.keys() == want.keys() and "dino_pe_feats" not in out
    for k, ref in want.items():
        if k != "depth_preds_bins":
            assert rel(out[k], np.asarray(ref)) <= STAGE_RTOL, k
