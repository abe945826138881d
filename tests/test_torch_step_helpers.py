"""Shared harness of the stage-0 and stage-1 training-step tests (no tests
of its own): three chained JAX steps of ``pipelines.make_train_step`` on
the CPU, and the checks that hold the port's steps to them.

The JAX side (``jax_stage_run``): a seeded flax-shaped weight tree with
every BatchNorm jittered (and a PE-free map at its flax init, 0.05 N), the
JAX optimizer on one device, drop-connect masks from numpy fed through a
test-local ``jax.random.bernoulli`` (the step is traced once and called
three times), the state before each step, each step's metrics and its
gradient (read back from Adam's first moment, mu_t = b1 mu_(t-1) +
(1 - b1) g_t), and at the first state the exact gradient: the same loss
closure in f64 (x64 on, the JAX BatchNorm's cast to f32 lifted here; an
f64 run of XLA's CPU convolutions takes seconds, so one state only).

The checks. At this size the train-mode gradient is badly conditioned
within f32's reach (B=2 BatchNorms over few values, ReLU kinks that
rounding flips, squeeze-excite sums that cancel: the stage-2 tests read up
to 8e-2 of a tensor between JAX's f32 gradient and its own f64 one), so
f32 gradients are held by module (a conv's or a BatchNorm's parameters
together) to MODULE_RTOL, against JAX's f32 gradient and the port's own
f64 one, and at the first state the port's f64 gradient per tensor
against JAX's to F64_RTOL of the larger of the tensor's largest entry and
ZERO_FLOOR of the model's (a bias that a train-mode BatchNorm subtracts
out has an exact gradient of 0). A
control, every BatchNorm's batch statistics out of the gradient, must land
above F64_RTOL. Losses and metrics from the same state meet JAX's to
METRIC_RTOL (f32 sums in another order), ``grad_norm`` to GRAD_NORM_RTOL;
the first step's running statistics to STAT_RTOL; the chained parameters
to the sum of both sides' Adam updates, each at most lr * a_b per entry
(Cauchy-Schwarz), which checks the schedule, not the gradient.
"""
from __future__ import annotations

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict
from jax.sharding import NamedSharding, PartitionSpec as P

from creste_public_tpu.config.config import Config as JConfig
from creste_public_tpu.data.dataloader import EpochLoader as JLoader
from creste_public_tpu.data.dataloader import build_dataset as jbuild_dataset
from creste_public_tpu.losses import LossManager as JLossManager
from creste_public_tpu.models.blocks import convnets as jconvnets
from creste_public_tpu.parallel import make_mesh, shard_batch
from creste_public_tpu.training import optim as joptim
from creste_public_tpu.training import pipelines as jpipelines
from creste_public_tpu.training.state import TrainState as JTrainState
from creste_public_tpu_torch.config.groups import GROUPS
from creste_public_tpu_torch.models.blocks.convnets import BatchNorm
from creste_public_tpu_torch.training import pipelines
from creste_public_tpu_torch.training.loop import to_device
from creste_public_tpu_torch.weights import from_jax_variables
from tests.test_torch_helpers import jax_variables, jitter_bn, seeded_variables

STEPS = 3
STEPS_PER_EPOCH = 2
B1, B2 = 0.9, 0.999
METRIC_RTOL = 1e-4
GRAD_NORM_RTOL = 1e-2
STAT_RTOL = 1e-4
MODULE_RTOL = 5e-2
F64_RTOL = 1e-5
ZERO_FLOOR = 1e-2
CPU = torch.device("cpu")
STEM = "depthcomp.vision_backbone.effnet.trunk.conv_stem.weight"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch on one intra-op thread while a module of these tests runs
    (each test module imports this fixture). The suite runs several test
    processes at once on few cores, and torch's OpenMP workers, spinning
    while other processes compile JAX steps, made these modules several
    times slower than the same work run one process at a time."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def tiny_batches(keys, n: int = STEPS, batch: int = 2) -> list[dict]:
    """``n`` batches of ``synthetic_tiny`` through the JAX loader, cut to
    ``keys``."""
    ds = jbuild_dataset(JConfig(GROUPS["dataset"]["synthetic_tiny"]),
                        "train")
    loader = JLoader(ds, batch, seed=0, num_workers=1)
    got = (list(loader.epoch(0)) + list(loader.epoch(1)))[:n]
    return [{k: b[k] for k in keys} for b in got]


def multiview_batch(B: int = 2, V: int = 2, seed: int = 0) -> dict:
    """RGBD views with a shifted second camera and random labels (the JAX
    package's ``tests/test_pefree_multiview.py::make_batch``, seeded)."""
    rng = np.random.default_rng(seed)
    rgbd = rng.uniform(0, 1, (B, V, 64, 80, 4)).astype(np.float32)
    rgbd[..., 3] *= 3000.0
    fx = fy = 72.0
    kinv = np.array([[1 / fx, 0, -40 / fx], [0, 1 / fy, -32 / fy],
                     [0, 0, 1.0]])
    rot = np.array([[0, 0, 1.0], [-1, 0, 0], [0, -1, 0]])
    p2p = np.eye(4, dtype=np.float32)
    p2p[:3, :3] = (rot @ kinv / 4).astype(np.float32)  # ds=4 intrinsics
    p2p = np.tile(p2p, (B, V, 1, 1))
    if V > 1:
        p2p[:, 1, 0, 3] = 0.2
    depth_label = rng.uniform(300, 3000, (B, V, 64, 80)).astype(np.float32)
    fimg = rng.normal(size=(B, V, 16, 20, 16)).astype(np.float32)
    return {"image": rgbd, "p2p": p2p, "depth_label": depth_label,
            "fimg_label": fimg}


def make_masks(n: int, batch: int, seed: int = 7) -> list[np.ndarray]:
    """``n`` drop-connect masks [batch, 1, 1, 1], two entries dropped."""
    rng = np.random.default_rng(seed)
    masks = [rng.uniform(size=(batch, 1, 1, 1)) > 0.3 for _ in range(n)]
    masks[0][-1] = masks[n // 2][0] = False
    return masks


class Feeder:
    """Fed drop-connect masks, in call order, for the port's trunk."""

    def __init__(self, masks, dtype=torch.float32):
        self.masks, self.calls, self.dtype = masks, 0, dtype

    def __call__(self, batch, keep):
        m = self.masks[self.calls % len(self.masks)]
        self.calls += 1
        assert m.shape == (batch, 1, 1, 1)
        return torch.from_numpy(m).to(self.dtype)


@contextlib.contextmanager
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


class KeepF64:
    """``jax.numpy`` for the JAX package's BatchNorm wrapper, whose
    ``jnp.asarray(x, jnp.float32)`` would round an f64 stream to f32."""

    def __init__(self, jnp_):
        self._jnp = jnp_

    def __getattr__(self, name):
        return getattr(self._jnp, name)

    def asarray(self, x, dtype=None, **kw):
        if getattr(x, "dtype", None) == self._jnp.float64:
            return x
        return self._jnp.asarray(x, dtype, **kw)


def flat(tree, prefix) -> dict[str, np.ndarray]:
    return {f"{prefix}/{k}": np.asarray(v)
            for k, v in flatten_dict(tree, sep="/").items()}


def flat_state(state) -> dict[str, np.ndarray]:
    return dict(flat(state.params, "params"),
                **flat(state.batch_stats, "batch_stats"))


def rel(got, want) -> float:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def seeded_stage_variables(jm, batch: dict, seed: int = 0
                           ) -> dict[str, np.ndarray]:
    """``seeded_variables`` of a stage model with jittered BatchNorms and a
    PE-free map (if any) at 0.05 N."""
    flat_vars = jitter_bn(seeded_variables(jm, batch["image"], batch["p2p"],
                                           seed=seed))
    pe = "params/learnable_pe_map"
    if pe in flat_vars:
        flat_vars[pe] = (0.05 * np.random.default_rng(seed + 5).normal(
            size=flat_vars[pe].shape)).astype(np.float32)
    return flat_vars


def jax_stage_run(stage: str, cfg: dict, batches: list[dict],
                  masks: list[np.ndarray], task: str | None = None) -> dict:
    """The JAX side of a stage's step tests (see the module docstring)."""
    b0 = batches[0]
    jm = jpipelines.build_model(stage, cfg)
    flat_vars = seeded_stage_variables(jm, b0)
    variables = jax_variables(flat_vars)
    params, stats = variables["params"], variables.get("batch_stats", {})
    tx = joptim.make_optimizer(cfg["optimizer"], cfg["lr_scheduler"],
                               STEPS_PER_EPOCH)
    mesh = make_mesh(1)
    state = jax.device_put(JTrainState.create(params, stats, tx),
                           NamedSharding(mesh, P()))
    lm = JLossManager(cfg)
    step = jpipelines.make_train_step(stage, jm, lm, tx, mesh, task=task,
                                      donate=False)
    closure = jpipelines.make_loss_closure(stage, jm, lm, task)
    key = jax.random.PRNGKey(0)
    calls = {"bernoulli": 0}

    def bernoulli(key, p, shape):
        m = masks[calls["bernoulli"] % len(masks)]
        calls["bernoulli"] += 1
        assert tuple(shape) == m.shape
        return jnp.asarray(m)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "bernoulli", bernoulli)
        states, metrics = [state], []
        for b in batches:
            state, m = step(state, shard_batch(b, mesh), key)
            states.append(state)
            metrics.append({k: float(v) for k, v in m.items()})
        traced = calls["bernoulli"]
        # the exact gradient of the first state: the loss closure in f64
        with x64(), pytest.MonkeyPatch.context() as mp64:
            mp64.setattr(jconvnets, "jnp", KeepF64(jnp))
            f64 = functools.partial(
                jax.tree_util.tree_map,
                lambda x: jnp.asarray(np.asarray(x), jnp.float64)
                if np.issubdtype(np.asarray(x).dtype, np.floating)
                else jnp.asarray(x))
            exact = jax.tree_util.tree_map(np.array, jax.jit(jax.grad(
                lambda p, s, b: closure(p, s, b, key, None)[0]))(
                f64(params), f64(stats), f64(b0)))
    # each traced forward draws the masks in order
    assert traced % len(masks) == 0 and (traced > 0) == (len(masks) > 0)
    host = [jax.tree_util.tree_map(np.array, s) for s in states]
    return dict(stage=stage, cfg=cfg, task=task, batches=batches,
                masks=masks, states=host, metrics=metrics, exact=exact)


def port_model(run, t: int = 0):
    """The port's model, losses and state with the JAX state before step
    t (its parameters and running statistics)."""
    model, lm, state = pipelines.init_stage(
        run["stage"], run["cfg"], steps_per_epoch=STEPS_PER_EPOCH,
        device="cpu")
    model.load_state_dict(from_jax_variables(flat_state(run["states"][t])),
                          strict=True)
    return model, lm, state


def _mu(state) -> dict[str, np.ndarray]:
    return flat(state.opt_state[0].mu, "params")


def jax_grads(run, t: int) -> dict[str, torch.Tensor]:
    """The JAX step t's gradient, from Adam's first moment."""
    mu = _mu(run["states"][t + 1])
    prev = (_mu(run["states"][t]) if t else
            {k: np.zeros_like(v) for k, v in mu.items()})
    return from_jax_variables({k: (mu[k] - B1 * prev[k]) / (1 - B1)
                               for k in mu})


def exact_grads(run) -> dict[str, torch.Tensor]:
    """JAX's f64 gradient at the first state."""
    return from_jax_variables(flat(run["exact"], "params"))


def grads(model) -> dict[str, torch.Tensor]:
    return {k: p.grad for k, p in model.named_parameters()}


def grad_gaps(got: dict, want: dict) -> dict[str, float]:
    """max|d| of each gradient over the larger of its reference's largest
    entry and ZERO_FLOOR of the largest of them all."""
    scale = max(float(w.abs().max()) for w in want.values())
    return {k: float((got[k].double() - w.double()).abs().max())
            / max(float(w.abs().max()), ZERO_FLOOR * scale)
            for k, w in want.items()}


def module_gaps(got: dict, want: dict) -> dict[str, float]:
    """|got - want| / |want| over the gradients of each module together
    (a conv's weight and bias, a BatchNorm's scale and bias)."""
    groups: dict[str, list[str]] = {}
    for k in want:
        groups.setdefault(k.rsplit(".", 1)[0], []).append(k)
    out = {}
    for g, keys in groups.items():
        num = sum(float(((got[k].double() - want[k].double()) ** 2).sum())
                  for k in keys)
        den = sum(float((want[k].double() ** 2).sum()) for k in keys)
        out[g] = (num / max(den, 1e-300)) ** 0.5
    return out


def worst(gaps: dict[str, float]) -> tuple[str, float]:
    return max(gaps.items(), key=lambda kv: kv[1])


def f64_forward(bn):
    """The port's train-mode BatchNorm without its cast to f32."""
    def forward(x):
        dims = [0, *range(2, x.dim())]
        mean = x.mean(dims)
        var = torch.clamp((x * x).mean(dims) - mean * mean, min=0.0)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        mul = torch.rsqrt(var + bn.eps) * bn.weight
        return (x - mean.view(shape)) * mul.view(shape) + bn.bias.view(shape)
    return forward


def detached_stats_forward(bn):
    """Train-mode BatchNorm with its batch statistics out of the gradient,
    in the input's dtype."""
    def forward(x):
        dims = [0, *range(2, x.dim())]
        mean = x.mean(dims)
        var = torch.clamp((x * x).mean(dims) - mean * mean, min=0.0)
        return torch.nn.functional.batch_norm(
            x, mean.detach(), var.detach(), bn.weight, bn.bias, False, 0.0,
            bn.eps)
    return forward


def port_grads_f64(run, t: int, bn_forward=f64_forward
                   ) -> dict[str, torch.Tensor]:
    """The port's train-mode gradient of step t's loss in f64 from the JAX
    state before step t, every BatchNorm's forward ``bn_forward(bn)``."""
    model, lm, _ = port_model(run, t)
    model.double().train()
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.forward = bn_forward(m)
    batch = {k: v.double() if v.is_floating_point() else v
             for k, v in to_device(run["batches"][t], CPU).items()}
    loss_fn = pipelines.make_loss_closure(run["stage"], model, lm,
                                          run["task"])
    total, _ = loss_fn(batch, Feeder(run["masks"], torch.float64))
    total.backward()
    return grads(model)


def port_step_from(run, t: int):
    """The port's step t from the JAX state before it: (metrics,
    gradients)."""
    model, lm, state = port_model(run, t)
    metrics = pipelines.make_train_step(run["stage"], model, lm,
                                        run["task"])(
        state, to_device(run["batches"][t], CPU), Feeder(run["masks"]))
    return metrics, {k: g.clone() for k, g in grads(model).items()}


def check_forward_matches_flax(run, train: bool, rtol: float):
    """The stage's model from the JAX state before the first step on its
    batch, in eval mode or in train mode with the run's masks (then also
    its staged running statistics against flax's mutated ones): every
    output to ``rtol`` of its largest entry (an argmax output equal but
    where two logits lie within rounding). Returns the port's model."""
    b = run["batches"][0]
    state = run["states"][0]
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    jm = jpipelines.build_model(run["stage"], run["cfg"])
    masks = iter(run["masks"] * 2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "bernoulli",
                   lambda key, p, shape: jnp.asarray(next(masks)))
        out = jax.jit(lambda v, x, p2p: jm.apply(
            v, x, p2p, train=train,
            mutable=["batch_stats"] if train else False,
            rngs={"dropout": jax.random.PRNGKey(0)}))(
            variables, b["image"], b["p2p"])
    out, mutated = out if train else (out, None)
    model, _, _ = port_model(run)
    model.train(train)
    with torch.no_grad():
        got = model(torch.from_numpy(b["image"]), torch.from_numpy(b["p2p"]),
                    drop_connect=Feeder(run["masks"]) if train else None)
    assert got.keys() == out.keys()
    for k, ref in out.items():
        assert got[k].shape == ref.shape, k
        if k == "depth_preds_bins":
            assert np.mean(got[k].numpy() == np.asarray(ref)) > 0.99
            continue
        print(f"{run['stage']} {'train' if train else 'eval'} forward {k} "
              f"{rel(got[k], ref):.3e}")
        assert rel(got[k], ref) <= rtol, (k, rel(got[k], ref))
    if train:
        want = from_jax_variables(flat(mutated["batch_stats"],
                                       "batch_stats"))
        staged = {f"{name}.{leaf}": s_ for name, m in model.named_modules()
                  if isinstance(m, BatchNorm)
                  for s_, leaf in zip(m.staged, ("running_mean",
                                                 "running_var"))}
        assert staged.keys() == want.keys()
        for k, s_ in staged.items():
            assert rel(s_, want[k].numpy()) <= rtol, (k, rel(s_, want[k]))
    return model


def check_step_from_jax_state(run, t: int) -> None:
    """Step t of the port from the JAX state before it: JAX's loss and
    metrics, its ``grad_norm``, and every module's gradient against JAX's
    f32 gradient and the port's f64 one."""
    metrics, got = port_step_from(run, t)
    want_m = run["metrics"][t]
    assert metrics.keys() == want_m.keys()
    for k, ref in want_m.items():
        rtol = GRAD_NORM_RTOL if k == "grad_norm" else METRIC_RTOL
        np.testing.assert_allclose(float(metrics[k]), ref, rtol=rtol,
                                   atol=1e-7, err_msg=f"step {t} {k}")
    own64 = port_grads_f64(run, t)
    for name, ref in (("JAX f32", jax_grads(run, t)), ("port f64", own64)):
        assert ref.keys() == got.keys()
        w = worst(module_gaps(got, ref))
        print(f"{run['stage']} step {t + 1}: port f32 gradient against "
              f"{name}, largest module gap {w[1]:.3e} ({w[0]}); largest "
              f"tensor gap {worst(grad_gaps(got, ref))[1]:.3e}")
        assert w[1] <= MODULE_RTOL, (t, name, w)
    d = {k: rel(metrics[k], want_m[k]) for k in ("loss", "grad_norm")}
    print(f"{run['stage']} step {t + 1}: loss {d['loss']:.3e}, grad_norm "
          f"{d['grad_norm']:.3e} relative to JAX's")


def check_f64_gradient(run) -> None:
    """At the first state the port's f64 gradient meets JAX's per tensor,
    and the control (batch statistics out of the gradient) does not."""
    exact = exact_grads(run)
    own64 = port_grads_f64(run, 0)
    assert own64.keys() == exact.keys()
    w = worst(grad_gaps(own64, exact))
    ctl = grad_gaps(port_grads_f64(run, 0, detached_stats_forward), exact)
    print(f"{run['stage']} f64 gradient against JAX's: largest tensor gap "
          f"{w[1]:.3e} ({w[0]}); control at the stem {ctl[STEM]:.3e}")
    assert w[1] <= F64_RTOL, w
    assert ctl[STEM] > F64_RTOL, ctl[STEM]


def check_chained_steps(run) -> None:
    """STEPS chained steps of the port from the first JAX state: the masks
    drawn in order, Adam's count on every parameter, the first step's
    running statistics, and every parameter within the sum of both sides'
    Adam updates of JAX's."""
    model, lm, state = port_model(run)
    step = pipelines.make_train_step(run["stage"], model, lm, run["task"])
    cfg = run["cfg"]
    lr0 = float(cfg["optimizer"]["lr"])
    gamma = float(cfg["lr_scheduler"]["gamma"])
    feeder = Feeder(run["masks"])
    n_masks = len(run["masks"])
    bound = 0.0
    for t, batch in enumerate(run["batches"]):
        calls = feeder.calls
        metrics = step(state, to_device(batch, CPU), feeder)
        assert feeder.calls - calls == n_masks
        assert state.step == t + 1
        assert all(bool(torch.isfinite(v)) for v in metrics.values())
        counts = {int(s["step"]) for s in state.optimizer.state.values()}
        assert counts == {t + 1}
        want = from_jax_variables(flat_state(run["states"][t + 1]))
        got = model.state_dict()
        a = [(1 - B1) * B1 ** (t - s) / (1 - B1 ** (t + 1))
             for s in range(t + 1)]
        b = [(1 - B2) * B2 ** (t - s) / (1 - B2 ** (t + 1))
             for s in range(t + 1)]
        bound += 2 * lr0 * gamma ** (t // STEPS_PER_EPOCH) * np.sqrt(
            sum(x * x / y for x, y in zip(a, b)))
        for k, ref in want.items():
            if "running" in k:
                if t == 0:
                    assert rel(got[k], ref.numpy()) <= STAT_RTOL, k
                continue
            d = float((got[k] - ref).abs().max())
            assert d <= bound * (1 + 1e-3) + 1e-6 * float(ref.abs().max()), (
                t, k, d)
