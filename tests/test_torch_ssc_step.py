"""The port's stage-2 training step against the JAX package's
``pipelines.make_train_step("ssc", ...)`` on the CPU.

Setup: ``model=ssc_sam/tiny`` (the full EfficientNet trunk, 9 residual
blocks, so drop-connect fires), ``task="joint"``, B=2 batches of the
``synthetic_tiny`` dataset through the JAX package's EpochLoader; a seeded
flax-shaped weight tree with every BN jittered; the JAX state and
optimizer of ``init_stage`` (load setting ``strict``: nothing frozen) on
those weights; the epoch-scheduled freeze on, with the gates 0, 1, 1 on
the three steps (so the first step leaves the backbone still and the last
two cross the flip); two steps per epoch, so that the learning rate decays
before the third step. The drop-connect masks (9 per forward) and SupCon's
priorities come from numpy and go to both sides: a test-local
``jax.random.bernoulli`` and ``jax.random.uniform`` return them while the
JAX step is traced (once: the three steps reuse them), and the port's step
gets a mask callable and ``priorities=``. One JAX step is compiled and
called three times.

At this preset the train-mode gradient is discontinuous within f32's
reach: B=2 BatchNorms over as few as 8 values per channel make the
forward sensitive, and ReLU pre-activations in the Up blocks and the heads
lie within f32's rounding of zero, so a flipped kink moves a
tensor's gradient by up to ~8e-2 of its largest entry. At the first state
JAX's f32 backbone gradient differs from its own f64 one by 8.2e-2 (the
port's f32 by 5.6e-4), and the exact gradient itself jumps as far under a
1e-6 change of the image (``test_train_mode_drift_by_stage`` prints
these). So the gradients are held stage by stage
(``test_stage_gradients_match_jax``, at each of the three states): each
stage of the port (backbone, splat, decoder) gets the JAX forward's input
to that stage and the JAX VJP's cotangent at its output. The splat's
gradients are held per tensor to GRAD_RTOL, the decoder's by module (a
conv's or a BatchNorm's parameters together) to DECODER_MODULE_RTOL, the
backbone's by module to MODULE_RTOL against both JAX's f32 gradient and
the port's own f64 one, and at the first state the port's f64 backbone
gradient per tensor against JAX's f64 one to F64_RTOL (JAX with x64 on and
its BatchNorm's cast to f32 lifted in this file). The stage gradients'
norm, the gate applied, meets JAX's ``grad_norm`` at each step. A control
(every backbone BatchNorm's batch statistics out of the gradient) lands
above MODULE_RTOL and F64_RTOL. ``test_three_steps_match_jax`` holds each
step's loss and metrics from the JAX state before it, and the chained
port's Adam count, gate effect and first-step statistics;
``test_adam_replay_across_gate_flip`` holds Adam's update across the gate
flip on the JAX gradients to 1e-6.
"""
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from creste_public_tpu.config.config import Config as JConfig
from creste_public_tpu.data.dataloader import EpochLoader as JLoader
from creste_public_tpu.data.dataloader import build_dataset as jbuild_dataset
from creste_public_tpu.losses import LossManager as JLossManager
from creste_public_tpu.models.blocks import convnets as jconvnets
from creste_public_tpu.models.blocks.resnet import (
    InpaintingResNet18MultiHead as JDecoder,
)
from creste_public_tpu.models.blocks.splat import Camera2MapMulti as JSplat
from creste_public_tpu.models.distillation import (
    DistillationBackbone as JBackbone,
)
from creste_public_tpu.models.terrainnet import TerrainNet as JTerrainNet
from creste_public_tpu.parallel import make_mesh, shard_batch
from creste_public_tpu.training import optim as joptim
from creste_public_tpu.training import pipelines as jpipelines
from creste_public_tpu.training.state import TrainState as JTrainState
from creste_public_tpu_torch.config.groups import GROUPS
from creste_public_tpu_torch.models.blocks.convnets import (
    BatchNorm,
    discard_batch_stats,
)
from creste_public_tpu_torch.models.distillation import DistillationBackbone
from creste_public_tpu_torch.models.terrainnet import TerrainNet
from creste_public_tpu_torch.training import pipelines
from creste_public_tpu_torch.training.loop import to_device
from creste_public_tpu_torch.training.surgery import make_stage_loader
from creste_public_tpu_torch.weights import from_jax_variables, init_weights
from tests.test_torch_helpers import jax_variables, jitter_bn, seeded_variables
from tests.test_torch_step_helpers import (
    one_torch_thread,  # noqa: F401 (an autouse fixture)
)
from tests.test_torch_step_helpers import Feeder
from tests.test_torch_step_helpers import KeepF64 as _KeepF64
from tests.test_torch_step_helpers import f64_forward as _f64_forward
from tests.test_torch_step_helpers import flat as _flat
from tests.test_torch_step_helpers import flat_state as _flat_state
from tests.test_torch_step_helpers import rel as _rel
from tests.test_torch_step_helpers import x64 as _x64

STEPS = 3
STEPS_PER_EPOCH = 2
GATES = (0.0, 1.0, 1.0)
N_MASKS = 9  # residual blocks of the full b0 trunk
METRIC_RTOL = 1e-4
GRAD_NORM_RTOL = 1e-2
GRAD_NORM_E2E_RTOL = 5e-2
STAT_RTOL = 1e-4
DECODER_STAT_RTOL = 1e-3
GRAD_RTOL = 1e-4
DECODER_GRAD_RTOL = 1e-3
MODULE_RTOL = 5e-2
DECODER_MODULE_RTOL = 5e-3
F64_RTOL = 1e-5
ZERO_FLOOR = 1e-2
STAGE_RTOL = 1e-3
SPLAT_RTOL = 1e-5
ADAM_RTOL = 1e-6
MOMENT_RTOL = 1e-5
B1, B2 = 0.9, 0.999
CPU = torch.device("cpu")
HEADS = ("inpainting_sam_preds", "inpainting_sam_dynamic_preds",
         "elevation_preds")
BACKBONE_OUT = ("depth_preds_logits", "depth_preds_metric",
                "depth_preds_feats", "dino_pe_feats")
LOSS_INPUTS = HEADS + ("depth_preds_logits", "depth_preds_metric",
                       "dino_pe_feats")


def _masks() -> list[np.ndarray]:
    rng = np.random.default_rng(7)
    masks = [rng.uniform(size=(2, 1, 1, 1)) > 0.3 for _ in range(N_MASKS)]
    masks[0][1] = masks[4][0] = False
    return masks


@pytest.fixture(scope="module")
def jax_run():
    """Three JAX steps (one compiled step), the JAX step from the first
    state on a perturbed image, and the first state's forward and VJP
    stage by stage."""
    cfg = copy.deepcopy(GROUPS["model"]["ssc_sam/tiny"])
    ds = jbuild_dataset(JConfig(GROUPS["dataset"]["synthetic_tiny"]),
                        "train")
    loader = JLoader(ds, 2, seed=0, num_workers=1)
    batches = (list(loader.epoch(0)) + list(loader.epoch(1)))[:STEPS]
    for b, gate in zip(batches, GATES):
        b["_backbone_unfrozen"] = np.full((2,), gate, np.float32)
    b0 = batches[0]
    jm = JTerrainNet(cfg)
    flat = jitter_bn(seeded_variables(jm, b0["image"], b0["p2p"]))
    masks = _masks()
    n_pri = b0["3d_sam_label"].size
    pri = np.random.default_rng(8).uniform(size=n_pri).astype(np.float32)
    calls = {"bernoulli": 0, "uniform": 0}

    def bernoulli(key, p, shape):
        m = masks[calls["bernoulli"] % len(masks)]
        calls["bernoulli"] += 1
        assert tuple(shape) == m.shape
        return jnp.asarray(m)

    def uniform(key, shape, *args, **kwargs):
        calls["uniform"] += 1
        assert tuple(shape) == pri.shape
        return jnp.asarray(pri)

    variables = jax_variables(flat)
    params, stats = variables["params"], variables["batch_stats"]
    tx = joptim.make_optimizer(cfg["optimizer"], cfg["lr_scheduler"],
                               STEPS_PER_EPOCH)
    mesh = make_mesh(1)
    state = jax.device_put(JTrainState.create(params, stats, tx),
                           NamedSharding(mesh, P()))
    lm = JLossManager(cfg)
    step = jpipelines.make_train_step("ssc", jm, lm, tx, mesh, task="joint",
                                      freeze_backbone_schedule=True,
                                      donate=False)
    key = jax.random.PRNGKey(0)
    noise = np.random.default_rng(3).normal(size=b0["image"].shape)
    perturbed = dict(b0, image=(b0["image"] * (1 + 1e-6 * noise)).astype(
        np.float32), _backbone_unfrozen=np.ones((2,), np.float32))

    # the forward and the VJP of a state, stage by stage
    backbone = JBackbone(cfg)
    splat = JSplat(cfg["camera_projector"], scatter_mode="mean")
    kw = cfg["bev_classifier"]["net_kwargs"]
    decoder = JDecoder(num_classes=tuple(kw["num_classes"]),
                       output_prefix=tuple(kw["output_prefix"]))

    def run_stage(module, name, p, stats, *args):
        out, mut = module.apply(
            {"params": p, "batch_stats": stats[name]}, *args, train=True,
            mutable=["batch_stats"], rngs={"dropout": key})
        return out, mut["batch_stats"]

    def backbone_vjp(p, stats, image, p2p, cot_b):
        _, vjp = jax.vjp(
            lambda p: {k: run_stage(backbone, "depthcomp", p, stats, image,
                                    p2p)[0][k] for k in BACKBONE_OUT}, p)
        return vjp(cot_b)[0]

    @jax.jit
    def stage_vjps(params, stats, batch):
        image, p2p = batch["image"], batch["p2p"]
        ob, sb = run_stage(backbone, "depthcomp", params["depthcomp"], stats,
                           image, p2p)
        Hs, Ws = ob["depth_preds_metric"].shape[1:]
        depth = ob["depth_preds_metric"].reshape(2, 1, Hs, Ws)
        feats = ob["depth_preds_feats"].reshape(2, 1, Hs, Ws, -1)
        os_, ss = run_stage(splat, "cam2map", params["cam2map"], stats,
                            depth, feats, p2p)
        od, sd = run_stage(decoder, "bevclassifier", params["bevclassifier"],
                           stats, os_)
        outputs = dict(ob, **os_, **od)

        def total(sub):
            td = jpipelines.merge_tensor_dict(batch, dict(outputs, **sub),
                                              "joint")
            ld, _ = lm(td, {"rng": key})
            return JLossManager.total(ld)

        cot = jax.grad(total)({k: outputs[k] for k in LOSS_INPUTS})
        _, dec_vjp = jax.vjp(
            lambda p, bev: {k: run_stage(decoder, "bevclassifier", p, stats,
                                         {"bev_features": bev})[0][k]
                            for k in HEADS},
            params["bevclassifier"], os_["bev_features"])
        g_dec, cot_bev = dec_vjp({k: cot[k] for k in HEADS})
        _, splat_vjp = jax.vjp(
            lambda p, d, f: run_stage(splat, "cam2map", p, stats, d, f,
                                      p2p)[0]["bev_features"],
            params["cam2map"], depth, feats)
        g_splat, cot_depth, cot_feats = splat_vjp(cot_bev)
        cot_b = {
            "depth_preds_logits": cot["depth_preds_logits"],
            "depth_preds_metric": cot["depth_preds_metric"]
            + cot_depth.reshape(ob["depth_preds_metric"].shape),
            "depth_preds_feats": cot_feats.reshape(
                ob["depth_preds_feats"].shape),
            "dino_pe_feats": cot["dino_pe_feats"],
        }
        g_bb = backbone_vjp(params["depthcomp"], stats, image, p2p, cot_b)
        _, bb_eval_vjp = jax.vjp(
            lambda p: {k: backbone.apply(
                {"params": p, "batch_stats": stats["depthcomp"]}, image, p2p,
                train=False)[k] for k in BACKBONE_OUT}, params["depthcomp"])
        (g_bb_eval,) = bb_eval_vjp(cot_b)
        grads = {"depthcomp": g_bb, "cam2map": g_splat,
                 "bevclassifier": g_dec}
        staged = {"depthcomp": sb, "cam2map": ss, "bevclassifier": sd}
        return dict(outputs=outputs, cot=cot, cot_bev=cot_bev, cot_b=cot_b,
                    grads=grads, staged=staged, eval_grads=g_bb_eval)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "bernoulli", bernoulli)
        mp.setattr(jax.random, "uniform", uniform)
        states, metrics = [state], []
        for b in batches:
            state, m = step(state, shard_batch(b, mesh), key)
            states.append(state)
            metrics.append({k: float(v) for k, v in m.items()})
        perturbed_state, perturbed_m = step(
            states[0], shard_batch(perturbed, mesh), key)
        # the state before each step on that step's batch; writable copies:
        # the port's tests make tensors of them
        host = functools.partial(jax.tree_util.tree_map, np.asarray)
        vjps = [jax.tree_util.tree_map(np.array, stage_vjps(
            host(states[t].params), host(states[t].batch_stats), b))
            for t, b in enumerate(batches)]
        # the exact train-mode backbone gradient of the first state: the
        # same VJP in f64 (one compile and one run, ~50 s)
        with _x64(), pytest.MonkeyPatch.context() as mp64:
            mp64.setattr(jconvnets, "jnp", _KeepF64(jnp))
            f64 = functools.partial(
                jax.tree_util.tree_map,
                lambda x: jnp.asarray(np.asarray(x), jnp.float64))
            # depth_preds_metric leaves the JAX head in f32
            cot_b = dict(f64(vjps[0]["cot_b"]), depth_preds_metric=jnp.asarray(
                vjps[0]["cot_b"]["depth_preds_metric"], jnp.float32))
            exact = jax.jit(backbone_vjp)(
                f64(params["depthcomp"]), f64(stats), f64(b0["image"]),
                f64(b0["p2p"]), cot_b)
            vjps[0]["exact_grads"] = jax.tree_util.tree_map(np.array, exact)
    # each traced forward draws the 9 masks in order
    assert calls["bernoulli"] % N_MASKS == 0 and calls["uniform"] >= 2
    return dict(cfg=cfg, batches=batches, flat=flat, masks=masks, pri=pri,
                states=states, metrics=metrics, perturbed=perturbed,
                perturbed_state=perturbed_state, perturbed_m=perturbed_m,
                vjps=vjps)


def _port(run, t: int = 0, **kw):
    """The port's model, losses and state with the JAX state before step t
    (its parameters and running statistics)."""
    model, lm, state = pipelines.init_stage(
        "ssc", run["cfg"], steps_per_epoch=STEPS_PER_EPOCH, device="cpu",
        **kw)
    model.load_state_dict(from_jax_variables(_flat_state(run["states"][t])),
                          strict=True)
    return model, lm, state


def _mu_nu(state):
    adam = state.opt_state[0]
    return _flat(adam.mu, "params"), _flat(adam.nu, "params")


def _jax_grads(run, t) -> dict[str, torch.Tensor]:
    """The JAX step t's gradient (after the gate) from Adam's first moment:
    mu_t = b1 mu_(t-1) + (1 - b1) g_t."""
    mu = _mu_nu(run["states"][t + 1])[0]
    prev = (_mu_nu(run["states"][t])[0] if t else
            {k: np.zeros_like(v) for k, v in mu.items()})
    return from_jax_variables({k: (mu[k] - B1 * prev[k]) / (1 - B1)
                               for k in mu})


def _stage_grads(model, run, stage, t: int = 0):
    """The port's gradients of one stage on step t's batch from the JAX
    forward's input to it and the JAX VJP's cotangent at its output."""
    v = run["vjps"][t]
    outputs, cot, cot_bev, cot_b = (v[k] for k in ("outputs", "cot",
                                                   "cot_bev", "cot_b"))
    b0 = to_device(run["batches"][t], CPU)
    o = {k: torch.from_numpy(np.array(x)) for k, x in outputs.items()}
    model.zero_grad(set_to_none=True)
    discard_batch_stats(model)
    if stage == "depthcomp":
        out = model.depthcomp(b0["image"], b0["p2p"],
                              drop_connect=Feeder(run["masks"]))
        discard_batch_stats(model)
        cots = {k: torch.from_numpy(cot_b[k]) for k in BACKBONE_OUT}
        inputs = []
    elif stage == "cam2map":
        Hs, Ws = o["depth_preds_metric"].shape[1:]
        depth = o["depth_preds_metric"].reshape(2, 1, Hs, Ws)
        feats = o["depth_preds_feats"].reshape(2, 1, Hs, Ws, -1)
        depth.requires_grad_(True)
        feats.requires_grad_(True)
        out = model.cam2map(depth, feats, b0["p2p"])
        cots = {"bev_features": torch.from_numpy(cot_bev)}
        inputs = [depth, feats]
    else:
        bev = o["bev_features"].requires_grad_(True)
        out = model.bevclassifier({"bev_features": bev})
        cots = {k: torch.from_numpy(cot[k]) for k in HEADS}
        inputs = [bev]
    torch.autograd.backward([out[k] for k in cots], list(cots.values()))
    return out, inputs


def _grad_gaps(got: dict, want: dict, stage: str) -> dict[str, float]:
    """max|d| of each parameter gradient of ``stage`` over the larger of
    its reference's largest entry and ZERO_FLOOR of the stage's: a tensor
    whose exact gradient is 0 (a bias that a train-mode BatchNorm
    subtracts out) carries only rounding, held against the stage's
    scale."""
    refs = {k: v.numpy() for k, v in want.items() if k.startswith(stage)}
    scale = max(np.abs(r).max() for r in refs.values())
    return {k: float(np.abs(got[k].numpy() - r).max()
                     / max(np.abs(r).max(), ZERO_FLOOR * scale))
            for k, r in refs.items()}


def _grads(model) -> dict[str, torch.Tensor]:
    return {k: p.grad for k, p in model.named_parameters()}


def _module_gaps(got: dict, want: dict, stage: str) -> dict[str, float]:
    """|got - want| / |want| over the parameter gradients of each module
    of ``stage`` together (a conv's weight and bias, a BatchNorm's scale
    and bias)."""
    groups: dict[str, list[str]] = {}
    for k in want:
        if k.startswith(stage):
            groups.setdefault(k.rsplit(".", 1)[0], []).append(k)
    out = {}
    for g, keys in groups.items():
        num = sum(float(((got[k].double() - want[k].double()) ** 2).sum())
                  for k in keys)
        den = sum(float((want[k].double() ** 2).sum()) for k in keys)
        out[g] = (num / max(den, 1e-300)) ** 0.5
    return out


def _exact(run) -> dict[str, torch.Tensor]:
    """JAX's train-mode backbone gradient of the first state in f64."""
    return from_jax_variables(_flat({"depthcomp": run["vjps"][0][
        "exact_grads"]}, "params"))


def _backbone_grads_f64(run, t: int, bn_forward,
                        nudge: float = 0.0) -> dict[str, torch.Tensor]:
    """The port's train-mode backbone gradient at step t in f64, every
    BatchNorm's forward replaced by ``bn_forward(bn)``, the image changed
    by ``nudge`` of itself (seeded normal noise)."""
    model, _, _ = _port(run, t)
    model.double().train()
    for m in model.depthcomp.modules():
        if isinstance(m, BatchNorm):
            m.forward = bn_forward(m)
    b = to_device(run["batches"][t], CPU)
    noise = np.random.default_rng(3).normal(size=b["image"].shape)
    image = b["image"].double() * (1 + nudge * torch.from_numpy(noise))
    feeder = Feeder(run["masks"])
    out = model.depthcomp(
        image, b["p2p"].double(),
        drop_connect=lambda n, keep: feeder(n, keep).double())
    cot_b = run["vjps"][t]["cot_b"]
    torch.autograd.backward(
        [out[k] for k in BACKBONE_OUT],
        [torch.from_numpy(cot_b[k]).to(out[k].dtype) for k in BACKBONE_OUT])
    return _grads(model)


@pytest.mark.parametrize("t", range(STEPS))
def test_stage_gradients_match_jax(jax_run, t):
    """Every parameter's gradient, stage by stage, from the JAX state
    before step t on step t's batch (so each chained step's gradient is
    held), each stage's staged running statistics, its output and the
    gradient it passes back."""
    run = jax_run
    model, _, _ = _port(run, t)
    model.train()
    v = run["vjps"][t]
    outputs, cot, cot_bev, cot_b = (v[k] for k in ("outputs", "cot",
                                                   "cot_bev", "cot_b"))
    want_g = from_jax_variables(_flat(v["grads"], "params"))
    want_s = from_jax_variables(_flat(v["staged"], "batch_stats"))
    bns = dict(model.named_modules())
    checked = set()
    grads: dict[str, torch.Tensor] = {}
    for stage in ("cam2map", "bevclassifier", "depthcomp"):
        out, inputs = _stage_grads(model, run, stage, t)
        for k, x in out.items():
            if k in outputs and k != "bev_coords":
                assert _rel(x, outputs[k]) <= STAGE_RTOL, (stage, k)
        gaps = _grad_gaps(_grads(model), want_g, stage)
        if stage == "depthcomp":
            # f32 by module, against JAX's f32 gradient and the port's own
            # f64 one; at the first state the port's f64 gradient against
            # JAX's f64 one per tensor (see the module docstring)
            own64 = _backbone_grads_f64(run, t, _f64_forward)
            for ref in (want_g, own64):
                worst = max(_module_gaps(_grads(model), ref, stage).items(),
                            key=lambda kv: kv[1])
                assert worst[1] <= MODULE_RTOL, worst
            if t == 0:
                for k, d in _grad_gaps(own64, _exact(run), stage).items():
                    assert d <= F64_RTOL, (k, d)
        elif stage == "bevclassifier":
            worst = max(_module_gaps(_grads(model), want_g, stage).items(),
                        key=lambda kv: kv[1])
            assert worst[1] <= DECODER_MODULE_RTOL, worst
        else:
            for k, d in gaps.items():
                assert d <= GRAD_RTOL, (k, d)
        checked |= set(gaps)
        grads.update({k: g.clone() for k, g in _grads(model).items()
                      if k.startswith(stage)})
        if stage != "depthcomp":
            for name, m in bns.items():
                if isinstance(m, BatchNorm) and name.startswith(stage):
                    for got, leaf in zip(m.staged, ("running_mean",
                                                    "running_var")):
                        d = _rel(got, want_s[f"{name}.{leaf}"].numpy())
                        assert d <= STAT_RTOL, (name, leaf, d)
        if stage == "cam2map":
            # the gradient the splat passes back into the backbone
            want_depth = (cot_b["depth_preds_metric"]
                          - cot["depth_preds_metric"])
            assert _rel(inputs[0].grad, want_depth.reshape(
                inputs[0].shape)) <= GRAD_RTOL
            assert _rel(inputs[1].grad, cot_b["depth_preds_feats"].reshape(
                inputs[1].shape)) <= GRAD_RTOL
        if stage == "bevclassifier":
            assert _rel(inputs[0].grad, cot_bev) <= DECODER_GRAD_RTOL
    assert checked == {k for k, _ in model.named_parameters()}
    # the step's grad_norm over these gradients, the gate applied
    gn = float(torch.sqrt(sum(
        (g.double() ** 2).sum() for k, g in grads.items()
        if GATES[t] == 1.0 or not k.startswith("depthcomp"))))
    np.testing.assert_allclose(gn, run["metrics"][t]["grad_norm"],
                               rtol=GRAD_NORM_RTOL)


def test_backbone_gradient_eval_form_matches_jax(jax_run):
    """The backbone's gradient with BatchNorm on its running statistics
    (the same cotangents) is well conditioned: every tensor to
    DECODER_GRAD_RTOL (a deep stack of f32 sums in another order; the
    squeeze-excite weights read up to 3.4e-4).
    And a control: the train-mode gradient with every BatchNorm's batch
    statistics taken out of the gradient lands above the stem's own bar
    in the train-mode test."""
    run = jax_run
    model, _, _ = _port(run)
    v = run["vjps"][0]
    want = from_jax_variables(_flat({"depthcomp": v["eval_grads"]},
                                    "params"))
    b0 = to_device(run["batches"][0], CPU)
    model.eval()
    out = model.depthcomp(b0["image"], b0["p2p"])
    torch.autograd.backward([out[k] for k in BACKBONE_OUT],
                            [torch.from_numpy(v["cot_b"][k])
                             for k in BACKBONE_OUT])
    gaps = _grad_gaps(_grads(model), want, "depthcomp")
    assert max(gaps.values()) <= DECODER_GRAD_RTOL, max(gaps.items(),
                                                key=lambda kv: kv[1])

    # the controls: every BatchNorm's batch statistics taken out of the
    # train-mode gradient, in f32 (by module) and in f64 (per tensor)
    model.train()
    model.zero_grad(set_to_none=True)
    for m in model.depthcomp.modules():
        if isinstance(m, BatchNorm):
            m.forward = _detached_stats_forward(m)
    _stage_grads(model, run, "depthcomp")
    stem = "depthcomp.depthcomp.vision_backbone.effnet.trunk.conv_stem"
    want_train = from_jax_variables(_flat(v["grads"], "params"))
    gap = _module_gaps(_grads(model), want_train, "depthcomp")[stem]
    assert gap > MODULE_RTOL, gap
    gaps = _grad_gaps(_backbone_grads_f64(run, 0, _detached_stats_forward),
                      _exact(run), "depthcomp")
    assert gaps[f"{stem}.weight"] > F64_RTOL, gaps[f"{stem}.weight"]


def _detached_stats_forward(bn):
    """Train-mode BatchNorm with its batch statistics out of the gradient,
    in the input's dtype (f32 at least)."""
    def forward(x):
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        dims = [0, *range(2, x.dim())]
        mean = xf.mean(dims)
        var = torch.clamp((xf * xf).mean(dims) - mean * mean, min=0.0)
        return torch.nn.functional.batch_norm(
            xf, mean.detach(), var.detach(), bn.weight, bn.bias, False, 0.0,
            bn.eps).to(x.dtype)
    return forward


def test_three_steps_match_jax(jax_run):
    """Three chained steps of the port against the JAX steps, gates 0, 1, 1.

    At every step the port's step from the JAX state before it (the same
    parameters and statistics) gives JAX's loss and every metric, and its
    ``grad_norm`` to GRAD_NORM_RTOL at the first step and to
    GRAD_NORM_E2E_RTOL at the others: with the backbone's gradient in it,
    the end-to-end gradient crosses ReLU kinks that f32 rounding flips
    (1.9e-2 at the second step). ``test_stage_gradients_match_jax`` holds
    that step's gradient, and its norm to GRAD_NORM_RTOL, stage by stage.
    The chained port gives Adam's count on every parameter, the gate's
    effect (the backbone bit-still at 0 on both sides, every backbone
    tensor moving at 1) and the first step's running statistics.
    Its parameters are held to the sum of the two sides' Adam updates,
    each at most lr * a_b per entry whatever the gradient (Cauchy-Schwarz):
    that bound checks the learning-rate schedule, not the gradient."""
    run = jax_run
    model, lm, state = _port(run)
    step = pipelines.make_train_step("ssc", model, lm, task="joint",
                                     freeze_backbone_schedule=True)
    lr0 = float(run["cfg"]["optimizer"]["lr"])
    gamma = float(run["cfg"]["lr_scheduler"]["gamma"])
    feeder = Feeder(run["masks"])
    pri = torch.from_numpy(run["pri"])
    bound = 0.0
    a_b = []  # the Adam update's bound factor at each step
    for t, batch in enumerate(run["batches"]):
        want_m = run["metrics"][t]
        # the port's step from the JAX state before step t
        at_model, at_lm, at_state = _port(run, t)
        at_metrics = pipelines.make_train_step(
            "ssc", at_model, at_lm, task="joint",
            freeze_backbone_schedule=True)(
            at_state, to_device(batch, CPU), Feeder(run["masks"]),
            priorities=pri)
        assert at_metrics.keys() == want_m.keys()
        for k, ref in want_m.items():
            rtol = METRIC_RTOL
            if k == "grad_norm":
                rtol = GRAD_NORM_RTOL if t == 0 else GRAD_NORM_E2E_RTOL
            np.testing.assert_allclose(float(at_metrics[k]), ref, rtol=rtol,
                                       atol=1e-7, err_msg=f"step {t} {k}")

        before = {k: v.clone() for k, v in model.state_dict().items()}
        calls = feeder.calls
        metrics = step(state, to_device(batch, CPU), feeder, priorities=pri)
        assert feeder.calls - calls == N_MASKS
        assert state.step == t + 1
        assert metrics.keys() == want_m.keys()
        assert all(bool(torch.isfinite(v)) for v in metrics.values())
        if t == 0:  # the same state as at_model's
            for k in want_m:
                assert float(metrics[k]) == float(at_metrics[k]), k
        # Adam steps every parameter, the gated ones included
        counts = {int(s["step"]) for s in state.optimizer.state.values()}
        assert counts == {t + 1}
        assert int(run["states"][t + 1].opt_state[0].count) == t + 1
        want = from_jax_variables(_flat_state(run["states"][t + 1]))
        got = model.state_dict()
        jax_before = from_jax_variables(_flat_state(run["states"][t]))
        # |m_hat / sqrt(v_hat)| <= sqrt(sum a_s^2 / b_s) (Cauchy-Schwarz)
        # with m_hat = sum a_s g_s and v_hat = sum b_s g_s^2
        a = [(1 - B1) * B1 ** (t - s) / (1 - B1 ** (t + 1))
             for s in range(t + 1)]
        b = [(1 - B2) * B2 ** (t - s) / (1 - B2 ** (t + 1))
             for s in range(t + 1)]
        a_b.append(np.sqrt(sum(x * x / y for x, y in zip(a, b))))
        bound += 2 * lr0 * gamma ** (t // STEPS_PER_EPOCH) * a_b[-1]
        for k, ref in want.items():
            if "running" in k:
                if t == 0:
                    rtol = (DECODER_STAT_RTOL if
                            k.startswith("bevclassifier") else STAT_RTOL)
                    assert _rel(got[k], ref.numpy()) <= rtol, k
                continue
            moved = not torch.equal(got[k], before[k])
            jax_moved = not torch.equal(ref, jax_before[k])
            if k.startswith("depthcomp") and GATES[t] == 0.0:
                assert not moved and not jax_moved, k
            # the two sides' updates are each at most that bound per entry
            d = float((got[k] - ref).abs().max())
            assert d <= bound * (1 + 1e-3) + 1e-6 * float(ref.abs().max()), (
                t, k, d)
        if GATES[t] == 1.0:
            depthcomp = [k for k in want if k.startswith("depthcomp")
                         and "running" not in k]
            assert all(not torch.equal(got[k], before[k])
                       for k in depthcomp)


def test_adam_replay_across_gate_flip(jax_run):
    """The port's optimizer fed the JAX steps' gradients (the gated zeros
    of the first step included) gives the JAX parameters and moments."""
    run = jax_run
    model, _, state = _port(run)
    named = dict(model.named_parameters())
    for t in range(STEPS):
        for k, g in _jax_grads(run, t).items():
            named[k].grad = g
        state.optimizer.step()
        state.scheduler.step()
        want = from_jax_variables(_flat(run["states"][t + 1].params,
                                        "params"))
        mu, nu = (from_jax_variables(x) for x in
                  _mu_nu(run["states"][t + 1]))
        for k, ref in want.items():
            np.testing.assert_allclose(named[k].detach().numpy(), ref.numpy(),
                                       rtol=ADAM_RTOL, atol=1e-7,
                                       err_msg=f"step {t + 1} {k}")
            st = state.optimizer.state[named[k]]
            assert int(st["step"]) == t + 1
            # torch updates the moments by lerp, optax by b1 m + (1 - b1) g
            for got_m, ref_m in ((st["exp_avg"], mu[k]),
                                 (st["exp_avg_sq"], nu[k])):
                ref_m = ref_m.numpy()
                np.testing.assert_allclose(
                    got_m.numpy(), ref_m, rtol=MOMENT_RTOL,
                    atol=MOMENT_RTOL * np.abs(ref_m).max())


def _group_spread(a: dict, b: dict) -> dict[str, float]:
    """The largest ``_grad_gaps`` in each two-level module group."""
    out: dict[str, float] = {}
    for stage in ("depthcomp", "cam2map", "bevclassifier"):
        for k, d in _grad_gaps(a, b, stage).items():
            g = ".".join(k.split(".")[:2])
            out[g] = max(out.get(g, 0.0), d)
    return out


def test_train_mode_drift_by_stage(jax_run, capsys):
    """The port's own train-mode forward against JAX's, stage by stage
    (the same weights, masks and batch), the splat from JAX's inputs, and
    the first step's gradient: port against JAX beside JAX against itself
    with the image perturbed by 1e-6 relative. Prints the table."""
    run = jax_run
    outputs = run["vjps"][0]["outputs"]
    model, lm, state = _port(run)
    model.train()
    b0 = to_device(run["batches"][0], CPU)
    with torch.no_grad():
        own = model(b0["image"], b0["p2p"], b0["mv_mask"],
                    drop_connect=Feeder(run["masks"]))
        Hs, Ws = outputs["depth_preds_metric"].shape[1:]
        fed = model.cam2map(
            torch.from_numpy(outputs["depth_preds_metric"]).reshape(
                2, 1, Hs, Ws),
            torch.from_numpy(outputs["depth_preds_feats"]).reshape(
                2, 1, Hs, Ws, -1), b0["p2p"])
    discard_batch_stats(model)
    rows = [(k, _rel(own[k], outputs[k])) for k in
            BACKBONE_OUT + ("bev_features", "bev_densities") + HEADS]
    splat_rows = [(k, _rel(fed[k], outputs[k]))
                  for k in ("bev_features", "bev_densities")]
    for k, d in rows:
        assert d <= STAGE_RTOL, (k, d)
    for k, d in splat_rows:
        assert d <= SPLAT_RTOL, (k, d)

    # gradient of the first step with the gate open: the port's against
    # JAX's, and JAX's against itself on the perturbed image
    step = pipelines.make_train_step("ssc", model, lm, task="joint",
                                     freeze_backbone_schedule=True)
    m = step(state, to_device(run["perturbed"], CPU),
             Feeder(run["masks"]), priorities=torch.from_numpy(run["pri"]))
    mu_p = _mu_nu(run["perturbed_state"])[0]
    jax_p = from_jax_variables({k: v / (1 - B1) for k, v in mu_p.items()})
    jax_g = from_jax_variables(_flat(run["vjps"][0]["grads"], "params"))
    port_vs_jax = _group_spread(_grads(model), jax_p)
    jax_vs_jax = _group_spread(jax_p, jax_g)
    gn = (float(m["grad_norm"]), run["perturbed_m"]["grad_norm"])
    # the backbone's stage gradient at each step: the port's f32 and JAX's
    # f32 against the port's f64 (largest module gap, largest tensor gap);
    # at the first state each against JAX's f64 (largest tensor gap)
    exact_rows, first = [], []
    for t in range(STEPS):
        own64 = _backbone_grads_f64(run, t, _f64_forward)
        bb, _, _ = _port(run, t)
        bb.train()
        _stage_grads(bb, run, "depthcomp", t)
        jax32 = from_jax_variables(_flat(run["vjps"][t]["grads"], "params"))
        exact_rows.append([max(f(g, own64, "depthcomp").values())
                           for f in (_module_gaps, _grad_gaps)
                           for g in (_grads(bb), jax32)])
        if t == 0:
            first = [max(_grad_gaps(g, _exact(run), "depthcomp").values())
                     for g in (own64, _grads(bb), jax32)]
            jump = max(_grad_gaps(_backbone_grads_f64(
                run, t, _f64_forward, 1e-6), own64, "depthcomp").values())
    with capsys.disabled():
        print("\nstage-2 train-mode drift, port vs JAX (max|d| / max|ref|):")
        for k, d in rows:
            print(f"  forward {k:32s} {d:.3e}")
        for k, d in splat_rows:
            print(f"  splat from JAX's depth and feats {k:14s} {d:.3e}")
        print("  first-step gradient (gate 1, perturbed image), per group: "
              "port vs JAX | JAX vs JAX on the unperturbed image")
        for g in sorted(port_vs_jax):
            print(f"    {g:28s} {port_vs_jax[g]:.3e} | {jax_vs_jax[g]:.3e}")
        print(f"  grad_norm port {gn[0]:.7e} JAX {gn[1]:.7e}")
        print("  train-mode backbone stage gradient against the port's f64 "
              "one: port f32 | JAX f32, largest module gap; the same, "
              "largest tensor gap")
        for t, r in enumerate(exact_rows):
            print(f"    step {t + 1}: {r[0]:.3e} | {r[1]:.3e}; {r[2]:.3e} | "
                  f"{r[3]:.3e}")
        print("  step 1 against JAX's f64 one, largest tensor gap: port f64 "
              f"{first[0]:.3e}, port f32 {first[1]:.3e}, JAX f32 "
              f"{first[2]:.3e}; the port's f64 one under a 1e-6 change of "
              f"the image {jump:.3e}")


def test_step_refuses_a_missing_gate_or_priorities(jax_run):
    """With the scheduled freeze a batch must carry its gate, and a step
    fed drop-connect masks must be given SupCon's priorities."""
    run = jax_run
    model, lm, state = _port(run)
    batch = to_device(run["batches"][0], CPU)
    step = pipelines.make_train_step("ssc", model, lm, task="joint",
                                     freeze_backbone_schedule=True)
    pri = torch.from_numpy(run["pri"])
    ungated = {k: v for k, v in batch.items() if k != "_backbone_unfrozen"}
    with pytest.raises(KeyError, match="_backbone_unfrozen"):
        step(state, ungated, Feeder(run["masks"]), priorities=pri)
    with pytest.raises(ValueError, match="priorities"):
        step(state, batch, Feeder(run["masks"]))
    assert state.step == 0


def test_ssc_graft_from_stage1_checkpoint(tmp_path):
    """A stage-1 DistillationBackbone checkpoint grafts whole into
    TerrainNet's ``depthcomp`` (the splat and the decoder keep their init);
    a stage-2 checkpoint restores whole, except the decoder heads that
    ``ft_decoders_all`` re-initialises."""
    cfg = copy.deepcopy(GROUPS["model"]["ssc_sam/tiny"])
    stage1 = init_weights(DistillationBackbone(cfg), 11)
    d1 = tmp_path / "s1" / "step_7"
    d1.mkdir(parents=True)
    torch.save({"step": 7, "model": stage1.state_dict()}, d1 / "state.pt")
    model, _, state = pipelines.init_stage("ssc", cfg, device="cpu")
    init = {k: v.clone() for k, v in model.state_dict().items()}
    make_stage_loader("ssc", str(tmp_path / "s1"))(state)
    sd = model.state_dict()
    for k, v in stage1.state_dict().items():
        assert torch.equal(sd[f"depthcomp.{k}"], v), k
    for k, v in init.items():
        if not k.startswith("depthcomp."):
            assert torch.equal(sd[k], v), k

    trained = init_weights(TerrainNet(cfg), 12)
    d2 = tmp_path / "s2" / "step_3"
    d2.mkdir(parents=True)
    torch.save({"step": 3, "model": trained.state_dict()}, d2 / "state.pt")
    make_stage_loader("ssc", str(d2), "ft_decoders_all")(state)
    for k, v in model.state_dict().items():
        keep = "bevclassifier" in k and "head_" in k
        assert torch.equal(v, sd[k] if keep else trained.state_dict()[k]), k
    assert any("head_" in k for k in sd)
