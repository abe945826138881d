"""The port's mixed-precision (``compute_dtype: bfloat16``) training steps
against the JAX package's (``pipelines.make_loss_closure`` with the model
config's ``compute_dtype``), on the CPU at the tiny presets, one B=2 batch
of ``synthetic_tiny`` (the trunk at ``stage_repeats=1``: no residual
block, so no drop-connect mask is drawn).

Stage 3 casts only the frozen backbone: the reward head, VI, SVF and the
penalty stay f32. As ``tests/test_precision.py::
test_bf16_frozen_backbone_irl_step`` holds the JAX step, the port's step
gives the backbone no gradient and moves none of its parameters, and its
head gradient is f32, finite and live; at random weights the IRL gradient
is chaotic in the backbone's bf16 features, so the whole step is not held
to JAX's. The head's f32 island is held tightly instead: from the JAX bf16
forward's own input view and expected SVF, the port's loss meets JAX's to
``METRIC_RTOL`` and its head gradient JAX's bf16 head gradient to
``GRAD_RTOL`` of each parameter's largest entry (the bars of
tests/test_torch_train_step.py: f32 sums and a second-order backward in
another order).

Stage 2 casts the whole model (f32 masters, bf16 copies in the forward).
From the same state, with SupCon's priorities fed to both sides, every
loss of the step meets JAX's bf16 step's within ``BF16_NOISE_RATIO``
times the control plus ``LOSS_FLOOR`` of the loss. The control is JAX's
own bf16 spread: the largest change of each loss of JAX's bf16 step when
the image is multiplied by 1 + 1e-3 N (three draws; a change below bf16's
resolution of 2^-8 that re-rounds some of the stream): at random weights
a bf16 forward's losses move by up to ~0.6 (the dynamic-class
cross-entropy) under it, while the f32 step moves by ~1e-3. The port's f32
step's distance is printed beside. After the step the masters, the
gradients and the running statistics are f32 and finite, and the
parameters moved.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from creste_public_tpu.config import presets as jpresets
from creste_public_tpu.losses import LossManager as JLossManager
from creste_public_tpu.models.lfd import MaxEntIRL as JMaxEntIRL
from creste_public_tpu.models.terrainnet import TerrainNet as JTerrainNet
from creste_public_tpu.runtime.precision import cast_variables
from creste_public_tpu.training import pipelines as jpipelines
from creste_public_tpu_torch.losses.manager import LossManager
from creste_public_tpu_torch.training import pipelines
from creste_public_tpu_torch.training.loop import to_device
from creste_public_tpu_torch.weights import from_jax_variables
from tests.test_torch_helpers import jax_variables, jitter_bn, seeded_variables
from tests.test_torch_step_helpers import one_torch_thread  # noqa: F401
from tests.test_torch_step_helpers import tiny_batches

METRIC_RTOL = 1e-5
GRAD_RTOL = 1e-4
BF16_NOISE_RATIO = 2.0
LOSS_FLOOR = 1e-3
STAGE3_KEYS = ("image", "p2p", "traversability_label", "fov_mask")
STAGE2_KEYS = ("image", "p2p", "depth_label", "fimg_label", "fov_mask",
               "3d_sam_label", "3d_sam_dynamic_label", "elevation_label")


def _bf16(cfg: dict) -> dict:
    return dict(cfg, compute_dtype="bfloat16")


@pytest.fixture(scope="module")
def stage3():
    """The JAX bf16 closure's loss and gradient at the seeded state, and
    its bf16 train-mode forward's input view and expected SVF."""
    cfg = jpresets.tiny_traversability_config().to_dict()
    b = tiny_batches(STAGE3_KEYS, n=1)[0]
    flat = jitter_bn(seeded_variables(
        JMaxEntIRL(dict(cfg, solve_mdp=False)), b["image"], b["p2p"]))
    variables = jax_variables(flat)
    params, stats = variables["params"], variables["batch_stats"]
    jm16 = jpipelines.build_model("traversability", _bf16(cfg))
    closure = jpipelines.make_loss_closure("traversability", jm16,
                                           JLossManager(cfg))
    key = jax.random.PRNGKey(0)
    jb = {k: jnp.asarray(v) for k, v in b.items()}

    @jax.jit
    def run(params):
        (loss, (_, metrics)), grads = jax.value_and_grad(
            lambda p: closure(p, stats, jb, key), has_aux=True)(params)
        v16 = {"params": {**params, "backbone": cast_variables(
                   params["backbone"])},
               "batch_stats": {**stats, "backbone": cast_variables(
                   stats["backbone"])}}
        out, _ = jm16.apply(v16, jb["image"], jb["p2p"],
                            jb["traversability_label"], True,
                            mutable=["batch_stats"], rngs={"dropout": key})
        return loss, metrics, grads, out["input_view"], out["exp_svf"]

    loss, metrics, grads, iv, svf = run(params)
    return dict(cfg=cfg, batch=b, flat=flat, loss=float(loss),
                metrics={k: float(v) for k, v in metrics.items()},
                grads=grads, iv=np.asarray(iv), svf=np.asarray(svf))


def _head_grads(grads) -> dict[str, torch.Tensor]:
    """JAX's reward-head gradient as the port's parameter names."""
    flat = flatten_dict(grads["traversability_head"], sep="/")
    return from_jax_variables({f"params/traversability_head/{k}":
                               np.asarray(v) for k, v in flat.items()})


def _port_stage3(run):
    model, lm, state = pipelines.init_stage(
        "traversability", _bf16(run["cfg"]), device="cpu")
    model.load_state_dict(from_jax_variables(run["flat"]), strict=True)
    return model, lm, state


def test_stage3_bf16_step_casts_only_the_backbone(stage3):
    """One port bf16 stage-3 step: the backbone runs in bf16 (its BEV
    features reach the decoder bf16) and the reward head in f32; the
    backbone gets no gradient and its parameters stay bit-equal; every
    parameter and running statistic stays f32; the head gradient is f32,
    finite and live, like JAX's bf16 head gradient (same tensors, same
    shapes); loss and metrics finite."""
    model, lm, state = _port_stage3(stage3)
    seen = {}

    def record(name, get):
        def hook(module, args, out):
            seen.setdefault(name, get(args))
        return hook

    model.backbone.bevclassifier.register_forward_hook(
        record("decoder_in", lambda a: a[0]["bev_features"]))
    model.traversability_head.r.register_forward_hook(
        record("head_in", lambda a: a[0]))
    backbone0 = {k: v.clone() for k, v in model.named_parameters()
                 if k.startswith("backbone.")}
    step = pipelines.make_train_step("traversability", model, lm)
    metrics = step(state, to_device(stage3["batch"], torch.device("cpu")),
                   None)
    assert seen["decoder_in"].dtype == torch.bfloat16
    assert seen["head_in"].dtype == torch.float32
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert metrics.keys() == stage3["metrics"].keys() | {"grad_norm", "loss"}
    for k, p in model.named_parameters():
        assert p.dtype == torch.float32, k
        if k.startswith("backbone."):
            assert p.grad is None and torch.equal(p, backbone0[k]), k
    assert all(v.dtype == torch.float32 for k, v in model.state_dict().items()
               if "running" in k)
    jgrads = _head_grads(stage3["grads"])
    head = {k: p for k, p in model.named_parameters()
            if k.startswith("traversability_head.")}
    assert head.keys() == jgrads.keys()
    for k, p in head.items():
        assert p.grad.dtype == torch.float32, k
        assert p.grad.shape == jgrads[k].shape, k
        assert bool(torch.isfinite(p.grad).all()), k
    assert max(float(p.grad.abs().max()) for p in head.values()) > 0
    for path, g in jax.tree_util.tree_flatten_with_path(
            stage3["grads"]["backbone"])[0]:
        assert float(jnp.abs(g).max()) == 0.0


def test_stage3_bf16_head_island_matches_jax(stage3):
    """From the JAX bf16 forward's input view and expected SVF, the port's
    reward head (f32 masters, f32 compute) gives JAX's bf16 step's loss and
    metrics to ``METRIC_RTOL`` and its head gradient to ``GRAD_RTOL`` of
    each parameter's largest entry."""
    model, lm, _ = _port_stage3(stage3)
    model.train()
    iv = torch.from_numpy(stage3["iv"].copy())
    svf = torch.from_numpy(stage3["svf"].copy())
    batch = to_device(stage3["batch"], torch.device("cpu"))
    r = model.traversability_head.reward(iv)
    td = pipelines.merge_tensor_dict(batch, {
        "traversability_preds": r, "input_view": iv, "exp_svf": svf})
    ld, meta = lm(td, {"reward_fn": model.reward})
    loss = LossManager.total(ld)
    loss.backward()
    metrics = pipelines.loss_metrics(ld, meta)
    np.testing.assert_allclose(float(loss), stage3["loss"],
                               rtol=METRIC_RTOL)
    for k, v in stage3["metrics"].items():
        np.testing.assert_allclose(float(metrics[k]), v, rtol=METRIC_RTOL,
                                   atol=1e-7, err_msg=k)
    named = dict(model.named_parameters())
    for k, g in _head_grads(stage3["grads"]).items():
        ref = g.numpy()
        d = float(np.abs(named[k].grad.numpy() - ref).max())
        assert d <= GRAD_RTOL * max(np.abs(ref).max(), 1e-6), (k, d)


@pytest.fixture(scope="module")
def stage2():
    """JAX's stage-2 losses at the seeded state, bf16 (on the batch and on
    three perturbed copies of its image) and f32, with SupCon's priorities
    fed through a test-local ``jax.random.uniform``."""
    cfg = jpresets.tiny_terrainnet_config().to_dict()
    b = tiny_batches(STAGE2_KEYS, n=1)[0]
    flat = jitter_bn(seeded_variables(JTerrainNet(cfg), b["image"],
                                      b["p2p"]))
    variables = jax_variables(flat)
    pri = np.random.default_rng(8).uniform(
        size=b["3d_sam_label"].size).astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    metrics = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "uniform",
                   lambda key, shape, *a, **k: jnp.asarray(pri).reshape(shape))
        for name, c in (("bf16", _bf16(cfg)), ("f32", cfg)):
            closure = jpipelines.make_loss_closure(
                "ssc", jpipelines.build_model("ssc", c), JLossManager(c),
                task="joint")
            closure = jax.jit(closure)
            for s in (0, 1, 2, 3) if name == "bf16" else (0,):
                noise = np.random.default_rng(s).normal(size=b["image"].shape)
                image = (b["image"] * (1 + 1e-3 * noise * (s > 0))).astype(
                    np.float32)
                loss, (_, m) = closure(
                    variables["params"], variables["batch_stats"],
                    dict(jb, image=jnp.asarray(image)),
                    jax.random.PRNGKey(0))
                metrics[f"{name}/{s}"] = dict(
                    {k: float(v) for k, v in m.items()}, loss=float(loss))
    return dict(cfg=cfg, batch=b, flat=flat, pri=pri, metrics=metrics)


def test_stage2_bf16_step_matches_jax(stage2):
    """One port bf16 stage-2 step from the seeded state: each loss and the
    total within ``BF16_NOISE_RATIO`` x the control plus ``LOSS_FLOOR`` of
    JAX's bf16 step's; masters, gradients and running statistics f32 and
    finite; every trainable tensor moved."""
    runs = {}
    for name, cfg in (("bf16", _bf16(stage2["cfg"])), ("f32", stage2["cfg"])):
        model, lm, state = pipelines.init_stage("ssc", cfg, device="cpu")
        model.load_state_dict(from_jax_variables(stage2["flat"]),
                              strict=True)
        before = {k: v.clone() for k, v in model.state_dict().items()}
        step = pipelines.make_train_step("ssc", model, lm, task="joint")
        metrics = step(state, to_device(stage2["batch"], torch.device("cpu")),
                       None, priorities=torch.from_numpy(stage2["pri"]))
        runs[name] = (model, before, {k: float(v) for k, v in
                                      metrics.items()})
    model, before, got = runs["bf16"]
    jm = stage2["metrics"]
    want = jm["bf16/0"]
    port32 = runs["f32"][2]
    for k, ref in want.items():
        control = max(abs(jm[f"bf16/{s}"][k] - ref) for s in (1, 2, 3))
        d = abs(got[k] - ref)
        print(f"stage-2 bf16 {k}: port {got[k]:.6g} JAX {ref:.6g} |d| "
              f"{d:.3e}; control JAX bf16 spread {control:.3e}; port f32 "
              f"{abs(port32[k] - ref):.3e}, JAX f32 "
              f"{abs(jm['f32/0'][k] - ref):.3e}")
        assert d <= BF16_NOISE_RATIO * control + LOSS_FLOOR * abs(ref), k
    for k, p in model.named_parameters():
        assert p.dtype == torch.float32, k
        assert p.grad is not None and p.grad.dtype == torch.float32, k
        assert bool(torch.isfinite(p.grad).all()), k
    state = model.state_dict()
    for k, v in state.items():
        assert v.dtype == torch.float32 and bool(torch.isfinite(v).all()), k
    moved = [k for k in state if not torch.equal(state[k], before[k])]
    assert len(moved) > 0.9 * len(state)
    assert np.isfinite(got["grad_norm"]) and got["grad_norm"] > 0
