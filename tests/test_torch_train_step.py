"""The port's stage-3 training step against the JAX package's
``pipelines.make_train_step("traversability", ...)`` on the CPU.

Setup: the tiny traversability preset with ``stage_repeats=2``, so that the
EfficientNet trunk has residual blocks and drop-connect fires (at
``stage_repeats=1`` no b0 block is residual); B=2 batches of the
``synthetic_tiny`` dataset through the JAX package's EpochLoader; a seeded
flax-shaped weight tree with every BN jittered, the reward head's included,
so that the pre-step and post-step running statistics differ; the JAX
state and optimizer of ``init_stage`` (``TrainState.create`` with
``make_optimizer`` and the backbone frozen) on those weights. The
drop-connect masks come from numpy and go to both sides: a test-local
``jax.random.bernoulli`` returns them in call order while the JAX step is
traced, and a mask callable feeds the port's trunk. Two steps per epoch, so
that the learning rate decays before the third step.

``test_three_steps_match_jax`` holds three chained steps tightly. The
backbone in train mode differs from JAX's by ~1e-4 of its scale after the
splat (f32 sums in another order, then the depth-dependent splat weights),
and the ÷0.005 policy sharpening amplifies that in the SVF, so each port
step takes the head's input view and the expected SVF from the JAX
model's own train-mode forward at the JAX step's state; the rest of the
step is the port's (train-mode backbone with the fed masks, train-mode
reward head, MaxEntIRLLoss with its eval-form penalty, backward,
``state.train_step``'s Adam, grad norm and commit). Tolerances: the loss,
``grad_norm`` and every metric 1e-5 relative (f32 sums in another order);
the reward-head gradient 1e-4 of each parameter's largest entry (a second
order backward in another order; tests/test_torch_irl_loss.py); every
running statistic of the reward head and of the backbone up to the splat
1e-4 of its largest entry (batch means and variances, in another order),
those of the BEV decoder after the splat 1e-3 (the bar of
tests/test_torch_mdp_path.py for the backbone's maps, which the splat moves
by ~1e-4 of their scale); the backbone parameters bit unchanged on both
sides; every other parameter as ``_param_tol`` derives.

``test_whole_step_matches_jax`` runs the port's own step
(``make_train_step``) three times from the same state: the first step's
loss and metrics within 1e-2 (chip_smoke.py's end-to-end bar, FRAME_RTOL:
the splat's ~1e-4 passes through the train-mode head and the sharpening),
the backbone's running statistics at every step as above (the backbone is
frozen, so they depend only on the batch, the masks and the previous
statistics), the backbone parameters bit unchanged.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict
from jax.sharding import NamedSharding, PartitionSpec as P

from creste_public_tpu.config import presets as jpresets
from creste_public_tpu.config.config import Config as JConfig
from creste_public_tpu.data.dataloader import EpochLoader as JLoader
from creste_public_tpu.data.dataloader import build_dataset as jbuild_dataset
from creste_public_tpu.losses import LossManager as JLossManager
from creste_public_tpu.models.lfd import MaxEntIRL as JMaxEntIRL
from creste_public_tpu.parallel import make_mesh, shard_batch
from creste_public_tpu.training import optim as joptim
from creste_public_tpu.training import pipelines as jpipelines
from creste_public_tpu.training.state import TrainState as JTrainState
from creste_public_tpu_torch.config.groups import GROUPS
from creste_public_tpu_torch.losses.manager import LossManager
from creste_public_tpu_torch.models.blocks.convnets import commit_batch_stats
from creste_public_tpu_torch.ops.svf_kernel import expected_svf_cuda
from creste_public_tpu_torch.ops.vi_kernel import value_iteration_cuda
from creste_public_tpu_torch.training import pipelines
from creste_public_tpu_torch.training.loop import to_device
from creste_public_tpu_torch.training.state import train_step
from creste_public_tpu_torch.weights import from_jax_variables
from tests.test_torch_helpers import jax_variables, jitter_bn, seeded_variables
from tests.test_torch_step_helpers import (
    one_torch_thread,  # noqa: F401 (an autouse fixture)
)

STEPS = 3
STEPS_PER_EPOCH = 2
METRIC_RTOL = 1e-5
GRAD_RTOL = 1e-4
STAT_RTOL = 1e-4
DECODER_STAT_RTOL = 1e-3
WHOLE_STEP_RTOL = 1e-2
B1 = 0.9  # the preset's Adam beta1


def _masks() -> list[np.ndarray]:
    """One [2, 1, 1, 1] mask per residual block of the trunk (5 at
    stage_repeats=2), with zeros in three of them."""
    rng = np.random.default_rng(7)
    masks = [rng.uniform(size=(2, 1, 1, 1)) > 0.3 for _ in range(5)]
    masks[0][1] = masks[2][0] = False
    masks[4][:] = True
    return masks


class Feeder:
    """Fed drop-connect masks, in call order, for the port's trunk."""

    def __init__(self, masks):
        self.masks, self.calls = masks, 0

    def __call__(self, batch, keep):
        m = self.masks[self.calls % len(self.masks)]
        self.calls += 1
        assert m.shape == (batch, 1, 1, 1)
        return torch.from_numpy(m.astype(np.float32))


def _flat_state(state) -> dict[str, np.ndarray]:
    flat = {f"params/{k}": np.asarray(v)
            for k, v in flatten_dict(state.params, sep="/").items()}
    flat.update({f"batch_stats/{k}": np.asarray(v)
                 for k, v in flatten_dict(state.batch_stats, sep="/").items()})
    return flat


def _adam_mu(state) -> dict[str, np.ndarray]:
    mu = state.opt_state[1][0].mu
    return {f"params/{k}": np.asarray(v)
            for k, v in flatten_dict(mu, sep="/").items()}


@pytest.fixture(scope="module")
def jax_run():
    """Three JAX steps (one compiled step shared by the tests), the JAX
    train-mode forward's input view and expected SVF at each step's state,
    and everything the port needs to replay them."""
    cfg = jpresets.tiny_traversability_config().to_dict()
    cfg["vision_backbone"]["vision_backbone"]["effnet_cfgs"][
        "stage_repeats"] = 2
    ds = jbuild_dataset(JConfig(GROUPS["dataset"]["synthetic_tiny"]),
                        "train")
    loader = JLoader(ds, 2, seed=0, num_workers=1)
    batches = (list(loader.epoch(0)) + list(loader.epoch(1)))[:STEPS]
    b0 = batches[0]
    flat = jitter_bn(seeded_variables(
        JMaxEntIRL(dict(cfg, solve_mdp=False)), b0["image"], b0["p2p"]))
    masks = _masks()
    calls = [0]

    def bernoulli(key, p, shape):
        m = masks[calls[0] % len(masks)]
        calls[0] += 1
        assert tuple(shape) == m.shape
        return jnp.asarray(m)

    jm = JMaxEntIRL(cfg)
    variables = jax_variables(flat)
    params = variables["params"]
    # pipelines.init_stage's state and optimizer, on the seeded weights
    tx = joptim.make_optimizer(
        cfg["optimizer"], cfg["lr_scheduler"], STEPS_PER_EPOCH,
        trainable_mask=joptim.freeze_mask(
            params, lambda p: p.startswith("backbone")))
    mesh = make_mesh(1)
    state = jax.device_put(
        JTrainState.create(params, variables["batch_stats"], tx),
        NamedSharding(mesh, P()))
    step = jpipelines.make_train_step("traversability", jm,
                                      JLossManager(cfg), tx, mesh,
                                      donate=False)
    key = jax.random.PRNGKey(0)

    @jax.jit
    def forward(params, batch_stats, batch):
        out, _ = jm.apply(
            {"params": params, "batch_stats": batch_stats},
            batch["image"], batch["p2p"], batch["traversability_label"],
            True, mutable=["batch_stats"], rngs={"dropout": key})
        return (out["input_view"], out["exp_svf"],
                out["traversability_preds"], out["policy"])

    states, metrics, views = [state], [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "bernoulli", bernoulli)
        for b in batches:
            views.append(tuple(np.asarray(a) for a in forward(
                state.params, state.batch_stats, b)))
            state, m = step(state, shard_batch(b, mesh), key)
            states.append(state)
            metrics.append({k: float(v) for k, v in m.items()})
    assert calls[0] > 0 and calls[0] % len(masks) == 0
    return dict(cfg=cfg, batches=batches, flat=flat, masks=masks,
                states=states, metrics=metrics, views=views)


def _port(run):
    """The port's model, loss manager and state from the same weights
    (``init_stage`` on the CPU, then the JAX tree loaded)."""
    model, lm, state = pipelines.init_stage(
        "traversability", run["cfg"], steps_per_epoch=STEPS_PER_EPOCH,
        device="cpu")
    model.load_state_dict(from_jax_variables(run["flat"]), strict=True)
    return model, lm, state


def _forced_loss(model, lm, input_view, exp_svf):
    """The stage-3 loss closure with the head's input view and the expected
    SVF given: the train-mode backbone still runs (its statistics and the
    drop-connect masks), then the train-mode reward head on the given view,
    then the losses with the eval-form penalty."""

    def loss_fn(batch, drop_connect):
        model.backbone(batch["image"], batch["p2p"],
                       drop_connect=drop_connect)
        r = model.traversability_head.reward(input_view)
        td = pipelines.merge_tensor_dict(batch, {
            "traversability_preds": r, "input_view": input_view,
            "exp_svf": exp_svf})
        ld, meta = lm(td, {"reward_fn": model.reward})
        return LossManager.total(ld), pipelines.loss_metrics(ld, meta)

    return loss_fn


def _param_tol(g_hist, lr_hist, ref):
    """Per-entry tolerance of a parameter after len(g_hist) Adam steps.

    With the JAX gradient g_s of a step known to delta_s = GRAD_RTOL *
    max|g_s| (the gradient check), Adam's update lr * m_hat / (sqrt(v_hat)
    + eps) is a ratio of sums of the g's, so it moves by at most about
    lr * 2 delta / |g| per step while |g| > delta, and by at most 2 lr (a
    sign flip: the first step is lr * sign(g)) otherwise. Summed over the
    steps, with the smallest |g_s| seen so far, plus f32 rounding of the
    parameter."""
    tol = np.zeros_like(ref)
    gmin = np.full_like(ref, np.inf)
    for g, lr in zip(g_hist, lr_hist):
        gmin = np.minimum(gmin, np.abs(g))
        delta = GRAD_RTOL * np.abs(g).max()
        tol += lr * np.minimum(2.0, 4.0 * delta / np.maximum(gmin, 1e-30))
    return tol + 1e-6 * np.abs(ref) + 1e-9


def _check_stats(got: dict, want: dict, keys, what: str) -> None:
    for k in keys:
        ref = want[k].numpy()
        d = np.abs(got[k].numpy() - ref).max()
        rtol = (DECODER_STAT_RTOL if k.startswith("backbone.bevclassifier")
                else STAT_RTOL)
        assert d <= rtol * np.abs(ref).max(), (what, k, d)


def test_three_steps_match_jax(jax_run):
    run = jax_run
    model, lm, state = _port(run)
    lr0 = float(run["cfg"]["optimizer"]["lr"])
    gamma = float(run["cfg"]["lr_scheduler"]["gamma"])
    backbone0 = {k: v.clone() for k, v in model.state_dict().items()
                 if k.startswith("backbone") and "running" not in k}
    feeder = Feeder(run["masks"])
    g_hist: dict[str, list] = {}
    lr_hist = []
    prev_mu = {k: np.zeros_like(v) for k, v in _adam_mu(
        run["states"][0]).items()}
    for t, batch in enumerate(run["batches"]):
        iv, svf = (torch.from_numpy(a.copy()) for a in run["views"][t][:2])
        calls = feeder.calls
        metrics = train_step(state, _forced_loss(model, lm, iv, svf),
                             to_device(batch, torch.device("cpu")), feeder)
        assert feeder.calls - calls == len(run["masks"])
        assert state.step == t + 1
        lr_hist.append(lr0 * gamma ** (t // STEPS_PER_EPOCH))

        want_m = run["metrics"][t]
        assert metrics.keys() == want_m.keys()
        for k, v in want_m.items():
            np.testing.assert_allclose(float(metrics[k]), v,
                                       rtol=METRIC_RTOL, atol=1e-7,
                                       err_msg=f"step {t + 1} {k}")

        # the JAX step's gradient from Adam's first moment:
        # mu_t = b1 mu_(t-1) + (1 - b1) g_t
        mu = _adam_mu(run["states"][t + 1])
        grads = from_jax_variables({
            k: (mu[k] - B1 * prev_mu[k]) / (1 - B1) for k in mu
            if k.startswith("params/traversability_head")})
        prev_mu = mu
        named = dict(model.named_parameters())
        assert grads
        for k, g in grads.items():
            ref = g.numpy()
            d = np.abs(named[k].grad.numpy() - ref).max()
            assert d <= GRAD_RTOL * max(np.abs(ref).max(), 1e-6), (t, k, d)
            g_hist.setdefault(k, []).append(ref)
        assert max(np.abs(g.numpy()).max() for g in grads.values()) > 0

        want = from_jax_variables(_flat_state(run["states"][t + 1]))
        got = model.state_dict()
        _check_stats(got, want, [k for k in want if "running" in k],
                     f"step {t + 1}")
        for k, ref in want.items():
            if "running" in k:
                continue
            if k.startswith("backbone"):
                assert torch.equal(got[k], backbone0[k]), k
                assert torch.equal(ref, backbone0[k]), k
                continue
            tol = _param_tol(g_hist[k], lr_hist, ref.numpy())
            d = np.abs(got[k].numpy() - ref.numpy())
            assert (d <= tol).all(), (t, k, float(d.max()))
    # the head's running statistics moved with the steps
    head0 = from_jax_variables(run["flat"])
    moved = [k for k in head0 if k.startswith("traversability_head")
             and "running" in k and not torch.equal(head0[k],
                                                    model.state_dict()[k])]
    assert moved


def test_penalty_sees_pre_step_stats(jax_run):
    """The first step's penalty, evaluated on the running statistics the
    forward is about to write (what writing them in the forward, as
    ``F.batch_norm`` does, would give), differs from the JAX step's by far
    more than the tolerance, while the port's step matches it (above)."""
    run = jax_run
    model, lm, _ = _port(run)
    iv, svf = (torch.from_numpy(a.copy()) for a in run["views"][0][:2])
    batch = to_device(run["batches"][0], torch.device("cpu"))
    model.train()
    model.backbone(batch["image"], batch["p2p"],
                   drop_connect=Feeder(run["masks"]))
    r = model.traversability_head.reward(iv)
    commit_batch_stats(model)
    td = pipelines.merge_tensor_dict(batch, {
        "traversability_preds": r, "input_view": iv, "exp_svf": svf})
    _, meta = lm(td, {"reward_fn": model.reward})
    naive = float(meta["MaxEntIRLLoss/reward_penalty"].detach())
    want = run["metrics"][0]["MaxEntIRLLoss/reward_penalty"]
    assert abs(naive - want) > 100 * METRIC_RTOL * abs(want), (naive, want)


def test_whole_step_matches_jax(jax_run):
    run = jax_run
    model, lm, state = _port(run)
    step = pipelines.make_train_step("traversability", model, lm)
    backbone0 = {k: v.clone() for k, v in model.state_dict().items()
                 if k.startswith("backbone") and "running" not in k}
    feeder = Feeder(run["masks"])
    value_iteration_cuda.launches = expected_svf_cuda.launches = 0
    for t, batch in enumerate(run["batches"]):
        metrics = step(state, to_device(batch, torch.device("cpu")), feeder)
        if t == 0:
            want_m = run["metrics"][0]
            assert metrics.keys() == want_m.keys()
            for k, v in want_m.items():
                np.testing.assert_allclose(float(metrics[k]), v,
                                           rtol=WHOLE_STEP_RTOL, atol=1e-7,
                                           err_msg=k)
        want = from_jax_variables(_flat_state(run["states"][t + 1]))
        got = model.state_dict()
        _check_stats(got, want, [k for k in want if k.startswith("backbone")
                                 and "running" in k], f"step {t + 1}")
        for k, v in backbone0.items():
            assert torch.equal(got[k], v), k
    assert feeder.calls == STEPS * len(run["masks"])
    # on CPU tensors the MDP ops take their plain versions
    assert value_iteration_cuda.launches == expected_svf_cuda.launches == 0


def test_train_mode_drift_chain(jax_run, capsys):
    """Where the whole step's ~1e-3 comes from: the port's own train-mode
    forward at the first state (the same weights, masks and batch) against
    the JAX forward, stage by stage: the head's input view (after the
    backbone, the splat and the decoder), the reward, the unsharpened
    policy, the expected SVF after the 1/0.005 sharpening, and the reward
    head alone from JAX's input view. Prints the chain; each stage is held
    to the bar of its own kind."""
    run = jax_run
    model, _, _ = _port(run)
    model.train()
    batch = to_device(run["batches"][0], torch.device("cpu"))
    jiv, jsvf, jr, jpol = run["views"][0]
    with torch.no_grad():
        out = model(batch["image"], batch["p2p"],
                    batch["traversability_label"],
                    drop_connect=Feeder(run["masks"]))
        r_fed = model.traversability_head.reward(torch.from_numpy(
            jiv.copy()))
    chain = [
        ("input view (backbone, splat, decoder)",
         _rel_max(out["input_view"], jiv)),
        ("reward from JAX's input view", _rel_max(r_fed, jr)),
        ("reward", _rel_max(out["traversability_preds"], jr)),
        ("policy before sharpening", _rel_max(out["policy"], jpol)),
        ("expected SVF after sharpening", _rel_max(out["exp_svf"], jsvf)),
    ]
    with capsys.disabled():
        print("\nstage-3 train-mode drift, port vs JAX (max|d| / max|ref|):")
        for name, d in chain:
            print(f"  {name:40s} {d:.3e}")
    bars = (DECODER_STAT_RTOL, METRIC_RTOL, DECODER_STAT_RTOL,
            DECODER_STAT_RTOL, WHOLE_STEP_RTOL)
    for (name, d), bar in zip(chain, bars):
        assert d <= bar, (name, d, bar)


def _rel_max(got: torch.Tensor, want: np.ndarray) -> float:
    want = np.asarray(want)
    return float(np.abs(got.detach().numpy() - want).max()
                 / max(np.abs(want).max(), 1e-30))
