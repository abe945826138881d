"""The port's two-rank training steps against the JAX package's 2-device
``shard_map`` steps (``pipelines.make_train_step(..., make_mesh(2))`` and
``make_temporal_train_step``) on the CPU.

Setup: the tiny stage-2 preset (``ssc_sam/tiny``, the full trunk: nine
drop-connect masks per forward) and the tiny stage-3 preset
(``traversability/tiny``), each on a global B=4 batch of ``synthetic_tiny``
(two rows per rank and device); and the temporal stage-2 preset of
tests/test_torch_temporal.py on the first chunk (at ``bos``) of four
sequences. Seeded flax-shaped weights with jittered BatchNorms go to both
sides. Each device's drop-connect masks, SupCon priorities and pose noise
are fed: a test-local ``jax.random.bernoulli``, ``uniform`` and ``normal``
return, under ``shard_map``, the draws of the device that calls them
(``lax.axis_index``), and each port rank gets its own. The ranks are two
spawned processes in a gloo group (``tests/test_torch_dp_ranks.py``).

The bars are the single-device step tests' (tests/test_torch_step_helpers.py,
tests/test_torch_train_step.py, tests/test_torch_temporal.py): the
gradient, the mean over the ranks, read from the JAX step's Adam moment,
by module in f32 to MODULE_RTOL (the train-mode gradient of these presets
crosses ReLU kinks that f32 rounding flips); the metrics to METRIC_RTOL for
stage 2 and to WHOLE_STEP_RTOL for stage 3 (the policy sharpening amplifies
the splat's drift, tests/test_torch_train_step.py); ``grad_norm`` to
GRAD_NORM_RTOL; the running statistics, the mean over the ranks, to
STAT_RTOL of each tensor before the splat and DECODER_STAT_RTOL after it;
the temporal step's hidden state of each rank to HIDDEN_RTOL (the
temporal test's stage bar). The backbone's f32 gradient, which JAX's own
f32 step holds only to ~8e-2 of the exact one
(tests/test_torch_ssc_step.py), is held instead in f64 on both sides, per
tensor, to F64_DP_RTOL, with the one-process step as the control.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from creste_public_tpu.config.config import Config as JConfig
from creste_public_tpu.data.dataloader import EpochLoader as JLoader
from creste_public_tpu.data.dataloader import SequenceChunkLoader as JChunks
from creste_public_tpu.data.dataloader import build_dataset as jbuild_dataset
from creste_public_tpu.data.synthetic import SyntheticCodaDataset as JSynth
from creste_public_tpu.losses import LossManager as JLossManager
from creste_public_tpu.models.blocks import convnets as jconvnets
from creste_public_tpu.ops import splat as jsplat
from creste_public_tpu.parallel import make_mesh, shard_batch
from creste_public_tpu.training import optim as joptim
from creste_public_tpu.training import pipelines as jpipelines
from creste_public_tpu.training.state import TrainState as JTrainState
from creste_public_tpu.utils import depth as jdepth
from creste_public_tpu.utils import geometry as jgeometry
from creste_public_tpu_torch.config.groups import GROUPS
from creste_public_tpu_torch.weights import from_jax_variables
from tests.test_torch_dp_ranks import (
    dp_cases,
    f64_grads,
    make_masks,
    run_ranks,
)
from tests.test_torch_helpers import jax_variables, jitter_bn, seeded_variables
from tests.test_torch_step_helpers import (  # noqa: F401 (one_torch_thread)
    F64_RTOL,
    GRAD_NORM_RTOL,
    METRIC_RTOL,
    MODULE_RTOL,
    STAT_RTOL,
    KeepF64,
    flat,
    flat_state,
    grad_gaps,
    module_gaps,
    one_torch_thread,
    rel,
    worst,
    x64,
)
from tests.test_torch_temporal import _trajectory, temporal_cfg

WORLD = 2
B = 4
N_MASKS = 9
B1 = 0.9
WHOLE_STEP_RTOL = 1e-2
DECODER_STAT_RTOL = 1e-3
HIDDEN_RTOL = 1e-3
# the whole step's f64 gradient, per tensor, to the single-device tests'
# stage bar (F64_RTOL). Every f32 island is lifted to f64 on both sides: the
# JAX step's backprojection, depth expectation and splat (LiftF32) and the
# port's (tests/test_torch_dp_ranks.lift_f32). With an island left in f32 on
# one side the gradients part by ~1e-3: the first stage that parts is the
# depth expectation, whose bin values the port names in torch.float32 (the
# metric depth of the second rank's rows 6.1e-8 from JAX's, the BEV
# coordinates 6.1e-7, the elevation head 4.3e-6, and the elevation
# SmoothL1's gradient 1.3e-2). The one-process control reads 1.6
F64_DP_RTOL = F64_RTOL
CASES = {"ssc": ("ssc_sam/tiny", "joint"),
         "traversability": ("traversability/tiny", None)}


class LiftF32:
    """``jax.numpy`` for a JAX module whose f32 casts are lifted to f64
    (the f64 step's ``utils/geometry.py``, ``utils/depth.py`` and
    ``ops/splat.py``, which cast to f32 whatever their input)."""

    def __init__(self, jnp_):
        self._jnp = jnp_

    def __getattr__(self, name):
        return getattr(self._jnp, "float64" if name == "float32" else name)


def _per_device(draws: list) -> jnp.ndarray:
    """The draw of the calling device, under shard_map."""
    return jnp.asarray(np.stack(draws))[jax.lax.axis_index("data")]


class _Fed:
    """A ``jax.random`` function that returns, in call order, the calling
    device's draw of each call (``draws[device][call]``)."""

    def __init__(self, draws, real=None):
        self.draws, self.calls, self.real = draws, 0, real

    def __call__(self, key, *args, shape=None, **kwargs):
        shape = shape if shape is not None else args[-1] if args else ()
        per = [d[self.calls % len(d)] for d in self.draws]
        if self.real is not None and tuple(shape) != per[0].shape:
            return self.real(key, *args, **kwargs)
        assert tuple(shape) == per[0].shape, (shape, per[0].shape)
        self.calls += 1
        return _per_device(per)


def _adam_grads(state) -> dict[str, np.ndarray]:
    """The first step's gradient from Adam's first moment."""
    leaves = jax.tree_util.tree_leaves(
        state.opt_state, is_leaf=lambda x: hasattr(x, "mu"))
    (adam,) = [x for x in leaves if hasattr(x, "mu")]
    return {k: v / (1 - B1) for k, v in flat(adam.mu, "params").items()}


def _jax_state(jm, cfg, flat_vars, frozen=None):
    variables = jax_variables(flat_vars)
    tx = joptim.make_optimizer(
        cfg["optimizer"], cfg["lr_scheduler"], 2,
        trainable_mask=None if frozen is None else joptim.freeze_mask(
            variables["params"], frozen))
    state = JTrainState.create(variables["params"],
                               variables["batch_stats"], tx)
    return jax.device_put(state, NamedSharding(make_mesh(WORLD), P())), tx


def _step_case(stage: str) -> tuple[dict, dict]:
    """The port ranks' arguments and the JAX 2-device step's results."""
    model_name, task = CASES[stage]
    cfg = copy.deepcopy(GROUPS["model"][model_name])
    ds = jbuild_dataset(JConfig(GROUPS["dataset"]["synthetic_tiny"]),
                        "train")
    batch = next(iter(JLoader(ds, B, shuffle=False, num_workers=1).epoch(0)))
    jm = jpipelines.build_model(stage, cfg)
    init_cfg = dict(cfg, solve_mdp=False) if stage == "traversability" \
        else cfg
    flat_vars = jitter_bn(seeded_variables(
        jpipelines.build_model(stage, init_cfg), batch["image"][:1],
        batch["p2p"][:1]))
    frozen = ((lambda p: p.startswith("backbone"))
              if stage == "traversability" else None)
    state, tx = _jax_state(jm, cfg, flat_vars, frozen)
    masks = [make_masks(N_MASKS, B // WORLD, seed=30 + r)
             for r in range(WORLD)]
    pri = None
    mesh = make_mesh(WORLD)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "bernoulli", _Fed(masks))
        if stage == "ssc":
            n = batch["3d_sam_label"][:B // WORLD].size
            pri = [np.random.default_rng(40 + r).uniform(size=n).astype(
                np.float32) for r in range(WORLD)]
            mp.setattr(jax.random, "uniform", _Fed([[p] for p in pri]))
        step = jpipelines.make_train_step(stage, jm, JLossManager(cfg), tx,
                                          mesh, task=task, donate=False)
        new_state, metrics = step(state, shard_batch(batch, mesh),
                                  jax.random.PRNGKey(0))
        ref = dict(grads=_adam_grads(new_state),
                   state=flat_state(new_state),
                   metrics={k: float(v) for k, v in metrics.items()})
        if stage == "ssc":
            # the same step in f64: x64 on, the JAX BatchNorm's cast to f32
            # lifted, and the f32 casts of the backprojection, the depth
            # expectation and the splat
            with x64(), pytest.MonkeyPatch.context() as mp64:
                mp64.setattr(jconvnets, "jnp", KeepF64(jnp))
                for mod in (jgeometry, jdepth, jsplat):
                    mp64.setattr(mod, "jnp", LiftF32(jnp))
                state64, tx64 = _jax_state(jm, cfg, {
                    k: v.astype(np.float64) for k, v in flat_vars.items()})
                step64 = jpipelines.make_train_step(
                    stage, jm, JLossManager(cfg), tx64, mesh, task=task,
                    donate=False)
                batch64 = jax.tree_util.tree_map(
                    lambda v: v.astype(np.float64)
                    if np.issubdtype(v.dtype, np.floating) else v, batch)
                new64, _ = step64(state64, shard_batch(batch64, mesh),
                                  jax.random.PRNGKey(0))
                ref["grads64"] = _adam_grads(new64)
    port = dict(stage=stage, cfg=cfg, batch=batch, masks=masks, pri=pri,
                task=task, weights=from_jax_variables(flat_vars))
    return port, ref


def _temporal_case() -> tuple[dict, dict]:
    cfg = temporal_cfg()
    ds = JSynth(length=16, image_size=(64, 80), ds=4, grid=32,
                map_range=1.6, fdn_dim=16, horizon=10)
    chunk = next(iter(JChunks(ds, batch_size=B, seq_len=4, chunk_len=2,
                              shuffle=False).epoch(0)))
    keys = ("image", "depth_label", "fimg_label", "p2p", "fov_mask",
            "3d_sam_label", "3d_sam_dynamic_label", "elevation_label")
    chunk = dict({k: chunk[k] for k in keys},
                 pose=_trajectory(B, 2, seed=9))
    jm = jpipelines.build_model("ssc", cfg)
    flat_vars = jitter_bn(seeded_variables(
        jm, chunk["image"][:1], chunk["p2p"][:1],
        init=lambda r, img, p2p: jm.init(
            dict(r, noise=jax.random.PRNGKey(3)), img, p2p, None,
            train=False, pose=jnp.asarray(chunk["pose"][:1]))))
    state, tx = _jax_state(jm, cfg, flat_vars)
    n = chunk["3d_sam_label"][:B // WORLD].size
    pri = [np.random.default_rng(50 + r).uniform(size=n).astype(np.float32)
           for r in range(WORLD)]
    rng = np.random.default_rng(10)
    noise = [(rng.normal(size=(B // WORLD, 2)).astype(np.float32),
              rng.normal(size=(B // WORLD, 2, 2)).astype(np.float32))
             for _ in range(WORLD)]
    Hg = chunk["fov_mask"].shape[-1]
    template = [(np.zeros((B, Hg, Hg, 16), np.float32),
                 np.zeros((B, 4, 4), np.float32), np.zeros((B,), bool))]
    mesh = make_mesh(WORLD)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "uniform", _Fed([[p] for p in pri]))
        mp.setattr(jax.random, "normal", _Fed([list(n_) for n_ in noise]))
        step = jpipelines.make_temporal_train_step(
            jm, JLossManager(cfg), tx, mesh, task="joint", bos=True)
        new_state, metrics, hidden = step(
            state, shard_batch(chunk, mesh), jax.random.PRNGKey(0),
            shard_batch(template, mesh))
    port = dict(cfg=cfg, weights=from_jax_variables(flat_vars), chunk=chunk,
                hidden=template, priorities=pri, noise=noise)
    ref = dict(grads=_adam_grads(new_state), state=flat_state(new_state),
               metrics={k: float(v) for k, v in metrics.items()},
               hidden=jax.tree_util.tree_map(np.asarray, hidden))
    return port, ref


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    steps = [_step_case(stage) for stage in CASES]
    temporal = _temporal_case()
    ranks = run_ranks(dp_cases, WORLD, tmp_path_factory.mktemp("dpjax"),
                      [p for p, _ in steps], temporal[0], steps[0][0])
    out = {p["stage"]: (ref, [r["steps"][i] for r in ranks])
           for i, (p, ref) in enumerate(steps)}
    out["temporal"] = (temporal[1], [r["temporal"] for r in ranks])
    out["f64"] = (steps[0], [r["f64"] for r in ranks])
    return out


def _check(ref: dict, got: dict, metric_rtol: float) -> None:
    assert got["metrics"].keys() == ref["metrics"].keys()
    for k, v in ref["metrics"].items():
        rtol = GRAD_NORM_RTOL if k == "grad_norm" else metric_rtol
        np.testing.assert_allclose(got["metrics"][k], v, rtol=rtol,
                                   atol=1e-7, err_msg=k)
    want = from_jax_variables(ref["grads"])
    mine = got["grads"]
    # what the port records no gradient for, JAX steps with a zero one
    for k, w in want.items():
        if k not in mine:
            assert float(w.abs().max()) == 0.0, k
    want = {k: w for k, w in want.items() if k in mine}
    assert len(want) == len(mine) > 0
    # the backbone's f32 gradient is held in f64 per tensor instead
    # (test_two_rank_f64_gradient_matches_jax)
    after = {k: w for k, w in want.items() if not k.startswith("depthcomp")}
    assert after
    name, gap = worst(module_gaps(mine, after))
    assert gap <= MODULE_RTOL, (name, gap)
    sd = got["state"]
    stats = from_jax_variables({k: v for k, v in ref["state"].items()
                                if k.startswith("batch_stats")})
    assert stats
    for k, w in stats.items():
        after_splat = any(s in k for s in ("bevclassifier", "cam2map",
                                           "temporal_layer",
                                           "traversability_head"))
        bar = DECODER_STAT_RTOL if after_splat else STAT_RTOL
        assert rel(sd[k], w.numpy()) <= bar, (k, rel(sd[k], w.numpy()))


@pytest.mark.parametrize("stage", list(CASES))
def test_two_rank_step_matches_jax_two_device_step(runs, stage):
    ref, ranks = runs[stage]
    for k, v in ranks[0]["state"].items():
        assert torch.equal(v, ranks[1]["state"][k]), k
    _check(ref, ranks[0], METRIC_RTOL if stage == "ssc" else WHOLE_STEP_RTOL)


def test_two_rank_temporal_step_matches_jax(runs):
    ref, ranks = runs["temporal"]
    _check(ref, ranks[0], METRIC_RTOL)
    (h, cell_pose, valid), = ref["hidden"]
    for r, got in enumerate(ranks):
        (gh, gp, gv), = got["hidden"]
        rows = slice(r * B // WORLD, (r + 1) * B // WORLD)
        assert rel(gh, h[rows]) <= HIDDEN_RTOL, r
        np.testing.assert_array_equal(gp, cell_pose[rows])
        assert gv.all() and valid[rows].all()


def test_two_rank_f64_gradient_matches_jax(runs):
    """The stage-2 step's reduced gradient in f64 on both sides, per tensor
    (the larger of its largest entry and ZERO_FLOOR of the largest of all:
    a conv bias before a train-mode BatchNorm has an exact gradient of 0),
    to F64_DP_RTOL; the control, the one-process B=4 gradient (each
    BatchNorm over all four rows), lands ten times above it."""
    (port, ref), ranks = runs["f64"]
    want = from_jax_variables(ref["grads64"])
    for got in ranks:
        assert got.keys() == want.keys()
        name, gap = worst(grad_gaps(got, want))
        assert gap <= F64_DP_RTOL, (name, gap)
    one = f64_grads(port["stage"], port["cfg"], port["weights"],
                    port["batch"],
                    [np.concatenate(m) for m in zip(*port["masks"])],
                    np.concatenate(port["pri"]), port["task"])
    assert worst(grad_gaps(one, want))[1] > 10 * F64_DP_RTOL
