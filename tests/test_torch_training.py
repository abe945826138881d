"""The port's training pieces against the JAX package on the CPU: train-mode
BatchNorm, drop-connect in an MBConv block, the optimizer with its
staircase schedule and freeze mask, the load-setting predicates, the data
loader, checkpoints and surgery, resume, and the CLI.

Tolerances: BatchNorm as its test derives them from f32 rounding; the
MBConv block 1e-5 of its scale; the
optimizer 1e-6 relative (the same gradients, Adam's update written in
another order); loader batches, predicates and configs exactly.
"""
import json
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax.traverse_util import flatten_dict

from creste_public_tpu.config import presets as jpresets
from creste_public_tpu.config.config import Config as JConfig
from creste_public_tpu.config.config import compose_cli as jcompose_cli
from creste_public_tpu.config.config import load_yaml
from creste_public_tpu.data.dataloader import EpochLoader as JLoader
from creste_public_tpu.data.dataloader import build_dataset as jbuild_dataset
from creste_public_tpu.models.blocks.effnet import MBConvBlock as JMBConv
from creste_public_tpu.models.lfd import MaxEntIRL as JMaxEntIRL
from creste_public_tpu.training import optim as joptim
from creste_public_tpu_torch import train_traversability
from creste_public_tpu_torch.config import presets
from creste_public_tpu_torch.config.config import parse_value
from creste_public_tpu_torch.config.groups import GROUPS, ROOTS, compose_cli
from creste_public_tpu_torch.data.coda_dataset import CodaDataset
from creste_public_tpu_torch.data.dataloader import EpochLoader, build_dataset
from creste_public_tpu_torch.data.synthetic import collate
from creste_public_tpu_torch.models.blocks.convnets import (
    BatchNorm,
    commit_batch_stats,
    eval_form,
)
from creste_public_tpu_torch.models.blocks.effnet import (
    EfficientNetB0Trunk,
    MBConvBlock,
    drop_connect_mask,
)
from creste_public_tpu_torch.models.lfd import MaxEntIRL
from creste_public_tpu_torch.models.terrainnet import TerrainNet
from creste_public_tpu_torch.training import checkpoint as ckpt
from creste_public_tpu_torch.training import optim, pipelines
from creste_public_tpu_torch.training.loop import run_training, step_generator
from creste_public_tpu_torch.training.surgery import make_stage_loader
from creste_public_tpu_torch.weights import from_jax_variables, init_weights
from tests.test_torch_coda_tree import write_coda_tree
from tests.test_torch_helpers import (
    jax_variables,
    jitter_bn,
    nchw,
    nhwc,
    seeded_variables,
)
from tests.test_torch_step_helpers import (
    one_torch_thread,  # noqa: F401 (an autouse fixture)
)

CONFIG_DIR = os.path.join(os.path.dirname(__file__), "..", "configs")
CPU = torch.device("cpu")


def _close(got, want, rtol, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    d = np.abs(got - want).max()
    assert d <= rtol * max(np.abs(want).max(), 1e-12), (what, d)


@pytest.mark.parametrize("momentum", [0.9, 0.99])
def test_train_batchnorm_matches_flax(momentum):
    """Output, running statistics and input gradient against flax's
    BatchNorm(use_running_average=False) (fast variance), on a channel
    with mean ~1e3 like the stem's depth channel; torch's own
    F.batch_norm would update the variance unbiased and miss.

    The two sides take their f32 means in other orders, and E[x^2] -
    E[x]^2 keeps their rounding: per channel each mean agrees to
    k = 2 ceil(log2 n) + 2 unit roundoffs of E[|x|] (E[x^2] for the second
    moment), so the variance to k u E[x^2], the running statistics to
    (1 - momentum) of that, the output to |y - bias| times half the
    variance's relative error plus |scale / std| times the mean's, and the
    input gradient to its scale times the variance's relative error; each
    plus 1e-5 of its scale for the rest of the arithmetic."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 6, 5, 3)).astype(np.float32)
    x[..., 0] = 1e3 + 50 * x[..., 0]
    x[..., 2] = -2 + 3 * x[..., 2]
    w_out = rng.normal(size=x.shape).astype(np.float32)
    scale = np.array([0.7, 1.3, 0.9], np.float32)
    bias = np.array([0.1, -0.2, 0.3], np.float32)
    mean0 = np.array([990.0, 0.1, -1.0], np.float32)
    var0 = np.array([2000.0, 1.2, 8.0], np.float32)
    eps = 1e-3
    bn = fnn.BatchNorm(use_running_average=False, momentum=momentum,
                       epsilon=eps)
    v = {"params": {"scale": scale, "bias": bias},
         "batch_stats": {"mean": mean0, "var": var0}}

    def f(xx):
        y, mut = bn.apply(v, xx, mutable=["batch_stats"])
        return (y * w_out).sum(), (y, mut["batch_stats"])

    (_, (y_ref, stats)), gx_ref = jax.value_and_grad(f, has_aux=True)(
        jnp.asarray(x))
    y_ref, gx_ref = np.asarray(y_ref), np.asarray(gx_ref)

    n = x.size // x.shape[-1]
    k = 2 * int(np.ceil(np.log2(n))) + 2
    u = 2.0 ** -24
    x64 = x.astype(np.float64).reshape(n, -1)
    var = x64.var(0)
    tol_mean = k * u * np.abs(x64).mean(0)
    tol_var = k * u * (x64 ** 2).mean(0)

    m = BatchNorm(3, eps=eps, momentum=momentum)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(scale))
        m.bias.copy_(torch.from_numpy(bias))
        m.running_mean.copy_(torch.from_numpy(mean0))
        m.running_var.copy_(torch.from_numpy(var0))
    xt = nchw(x).requires_grad_(True)
    y = m.train()(xt)
    (y * nchw(w_out)).sum().backward()
    y_tol = (np.abs(y_ref - bias) * tol_var / (2 * (var + eps))
             + np.abs(scale) / np.sqrt(var + eps) * tol_mean
             + 1e-5 * np.abs(y_ref).max())
    assert (np.abs(nhwc(y.detach()) - y_ref) <= y_tol).all()
    g_scale = np.abs(gx_ref).reshape(n, -1).max(0)
    g_tol = g_scale * (1e-5 + tol_var / (var + eps))
    assert (np.abs(nhwc(xt.grad) - gx_ref) <= g_tol).all()
    # staged, not written, until the commit
    assert torch.equal(m.running_var, torch.from_numpy(var0))
    commit_batch_stats(m)
    assert m.staged is None
    rm_ref, rv_ref = np.asarray(stats["mean"]), np.asarray(stats["var"])
    assert (np.abs(m.running_mean.numpy() - rm_ref)
            <= (1 - momentum) * tol_mean + 1e-6 * np.abs(rm_ref)).all()
    rv_tol = (1 - momentum) * tol_var + 1e-6 * np.abs(rv_ref)
    assert (np.abs(m.running_var.numpy() - rv_ref) <= rv_tol).all()
    rm, rv = torch.from_numpy(mean0), torch.from_numpy(var0)
    torch.nn.functional.batch_norm(nchw(x), rm, rv, training=True,
                                   momentum=1 - momentum)
    assert (np.abs(rv.numpy() - rv_ref) > rv_tol).any()
    # eval form: the running statistics, as before
    with torch.no_grad():
        ye = m.eval()(nchw(x))
    want = ((x - m.running_mean.numpy()) / np.sqrt(m.running_var.numpy()
                                                   + eps) * scale + bias)
    _close(nhwc(ye), want, 1e-5, "eval")


def test_second_train_call_stages_on_the_first():
    """Two train-mode calls before a commit: flax's two updates in one
    apply."""
    m = BatchNorm(2, momentum=0.9).train()
    a, b = torch.randn(3, 2, 4, 4), torch.randn(3, 2, 4, 4)
    m(a)
    m(b)
    commit_batch_stats(m)

    def stats(x):
        mu = x.mean((0, 2, 3))
        return mu, (x * x).mean((0, 2, 3)) - mu * mu

    (ma, va), (mb, vb) = stats(a), stats(b)
    torch.testing.assert_close(m.running_mean, 0.9 * (0.1 * ma) + 0.1 * mb)
    torch.testing.assert_close(m.running_var,
                               0.9 * (0.9 + 0.1 * va) + 0.1 * vb)


def test_eval_form_restores_each_mode():
    m = MaxEntIRL(presets.tiny_traversability_config().to_dict()).train()
    m.traversability_head.r.prepool_0.eval()
    with eval_form(m.traversability_head):
        assert not any(x.training for x in m.traversability_head.modules())
    assert m.traversability_head.training
    assert not m.traversability_head.r.prepool_0.training
    assert m.traversability_head.r.prepool_1.training


def test_mbconv_drop_connect_matches_jax(monkeypatch):
    """A residual MBConv block in training with a fed mask that drops the
    second sample's branch, against the JAX block."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 8, 8, 24)).astype(np.float32)
    jb = JMBConv(24, 24, 3, 1, 6, (56, 56), 0.15)
    flat = jitter_bn(seeded_variables(jb, jnp.asarray(x)), seed=2)
    mask = np.array([True, False]).reshape(2, 1, 1, 1)
    seen = []

    def bernoulli(key, p, shape):
        seen.append((p, tuple(shape)))
        return jnp.asarray(mask)

    monkeypatch.setattr(jax.random, "bernoulli", bernoulli)
    ref, mut = jb.apply(jax_variables(flat), jnp.asarray(x), True,
                        mutable=["batch_stats"],
                        rngs={"dropout": jax.random.PRNGKey(0)})
    assert seen == [(pytest.approx(0.85), (2, 1, 1, 1))]
    tb = MBConvBlock(24, 24, 3, 1, 6, (56, 56), drop_rate=0.15)
    tb.load_state_dict(from_jax_variables(flat), strict=True)
    fed = []

    def source(batch, keep):
        fed.append((keep, batch))
        return torch.from_numpy(mask)

    with torch.no_grad():
        y = tb.train()(nchw(x), source)
    assert fed == [(pytest.approx(0.85), 2)]
    _close(nhwc(y), ref, 1e-5, "block output")
    # the dropped sample is the skip alone
    np.testing.assert_array_equal(nhwc(y)[1], x[1])
    commit_batch_stats(tb)
    want = from_jax_variables({f"batch_stats/{k}": np.asarray(v)
                               for k, v in flatten_dict(
                                   mut["batch_stats"], sep="/").items()})
    for k, v in want.items():
        _close(tb.state_dict()[k].numpy(), v.numpy(), 1e-5, k)
    # no drop-connect in eval mode, nor in a block without a skip
    with torch.no_grad():
        tb.eval()(nchw(x), lambda *a: pytest.fail("eval drew a mask"))


def test_drop_connect_rates_and_generator():
    trunk = EfficientNetB0Trunk(4, (64, 80), stage_repeats=2)
    rates = [getattr(trunk, f"block_{i}").drop_rate
             for i in range(trunk.n_blocks)]
    assert rates == [0.2 * i / 12 for i in range(12)]
    residual = [i for i in range(12) if getattr(trunk, f"block_{i}").residual]
    assert residual == [2, 4, 6, 8, 10]
    a = drop_connect_mask(step_generator(0, 3), 64, 0.5, CPU)
    b = drop_connect_mask(step_generator(0, 3), 64, 0.5, CPU)
    c = drop_connect_mask(step_generator(0, 4), 64, 0.5, CPU)
    assert a.shape == (64, 1, 1, 1) and torch.equal(a, b)
    assert not torch.equal(a, c) and set(a.unique().tolist()) == {0.0, 1.0}


def test_train_mode_residual_block_needs_a_mask_source():
    """Masks from torch's global generator could not be replayed on
    resume, so a train-mode residual block without a source raises; eval
    mode draws nothing and needs none."""
    trunk = EfficientNetB0Trunk(4, (64, 80), stage_repeats=2)
    block = trunk.block_2
    x = torch.randn(2, 24, 8, 10)
    with pytest.raises(ValueError, match="drop-connect source"):
        drop_connect_mask(None, 2, 0.5, CPU)
    with torch.no_grad(), pytest.raises(ValueError):
        block.train()(x)
    with torch.no_grad():
        assert block.eval()(x).shape == x.shape


class _Toy(torch.nn.Module):
    def __init__(self, params):
        super().__init__()
        for sub, leaves in params.items():
            m = torch.nn.Module()
            for k, v in leaves.items():
                m.register_parameter(k, torch.nn.Parameter(
                    torch.from_numpy(v.copy())))
            self.add_module(sub, m)


def test_optimizer_matches_optax():
    """Adam + staircase decay over two epochs of three steps, the backbone
    frozen, on the same gradient sequence (one step with gradients far
    below eps)."""
    rng = np.random.default_rng(3)
    params = {"backbone": {"w": rng.normal(size=(3, 4)).astype(np.float32)},
              "head": {"w": rng.normal(size=(5,)).astype(np.float32),
                       "b": rng.normal(size=(2, 3)).astype(np.float32)}}
    opt_cfg = {"name": "Adam", "beta1": 0.9, "beta2": 0.999, "lr": 1e-2,
               "eps": 1e-7}
    sched_cfg = {"name": "ExponentialLR", "gamma": 0.5}
    spe, steps = 3, 6
    grads = [{s: {k: (rng.normal(size=v.shape) * (1e-9 if t == 2 else 1))
                  .astype(np.float32) for k, v in leaves.items()}
              for s, leaves in params.items()} for t in range(steps)]

    def frozen(p):
        return p.startswith("backbone")

    tx = joptim.make_optimizer(opt_cfg, sched_cfg, spe,
                               joptim.freeze_mask(params, frozen))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    st = tx.init(jp)
    toy = _Toy(params)
    opt, sched = optim.make_optimizer(opt_cfg, sched_cfg, spe,
                                      optim.freeze(toy, frozen))
    assert [p.requires_grad for p in toy.parameters()] == [False, True, True]
    for t, g in enumerate(grads):
        upd, st = tx.update(jax.tree_util.tree_map(jnp.asarray, g), st, jp)
        jp = jax.tree_util.tree_map(lambda a, b: a + b, jp, upd)
        for name, p in toy.named_parameters():
            if p.requires_grad:
                s, k = name.split(".")
                p.grad = torch.from_numpy(g[s][k])
        opt.step()
        sched.step()
        for name, p in toy.named_parameters():
            s, k = name.split(".")
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jp[s][k]), rtol=1e-6,
                                       atol=1e-7, err_msg=f"step {t} {name}")
    np.testing.assert_array_equal(toy.backbone.w.detach().numpy(),
                                  params["backbone"]["w"])
    assert opt.param_groups[0]["lr"] == pytest.approx(1e-2 * 0.5 ** 2)


def test_scheduled_freeze_gate_matches_jax():
    rng = np.random.default_rng(4)
    grads = {"depthcomp": {"w": rng.normal(size=(3,)).astype(np.float32)},
             "head": {"w": rng.normal(size=(2,)).astype(np.float32)}}
    for gate in (0.0, 1.0):
        ref = joptim.scheduled_freeze_gate(
            jax.tree_util.tree_map(jnp.asarray, grads),
            lambda p: p.startswith("depthcomp"), jnp.asarray(gate))
        got = optim.scheduled_freeze_gate(
            {f"{s}.{k}": torch.from_numpy(v) for s, d in grads.items()
             for k, v in d.items()},
            lambda p: p.startswith("depthcomp"), gate)
        for s, d in grads.items():
            for k in d:
                np.testing.assert_array_equal(got[f"{s}.{k}"].numpy(),
                                              np.asarray(ref[s][k]))


@pytest.mark.parametrize("num_classes", [(32, 6, 2), (32, 6, 1)])
def test_load_setting_predicates_match_jax(num_classes):
    """Every LOAD_SETTING_FROZEN predicate over the production MaxEntIRL
    parameter tree, each flax path mapped to its port name by the weight
    rule table (and with a one-channel head, which ft_semantic_head
    unfreezes)."""
    cfg = jpresets.traversability_model_config().to_dict()
    cfg["solve_mdp"] = False
    cfg["vision_backbone"]["bev_classifier"]["net_kwargs"]["num_classes"] = (
        list(num_classes))
    tree = jax.eval_shape(lambda: JMaxEntIRL(cfg).init(
        {"params": jax.random.PRNGKey(0)},
        np.zeros((1, 1, 512, 612, 4), np.float32),
        np.zeros((1, 1, 4, 4), np.float32)))["params"]
    model = MaxEntIRL(cfg)
    named = dict(model.named_parameters())
    flat = flatten_dict(tree, sep="/")
    port_name = {k: next(iter(from_jax_variables(
        {f"params/{k}": np.zeros(v.shape, np.float32)}))) for k, v in
        flat.items()}
    assert sorted(port_name.values()) == sorted(named)
    unfrozen = {}
    for setting, pred in joptim.LOAD_SETTING_FROZEN.items():
        want = flatten_dict(joptim.freeze_mask(tree, pred), sep="/")
        got = optim.freeze_mask(named, optim.LOAD_SETTING_FROZEN[setting])
        assert {port_name[k]: bool(v) for k, v in want.items()} == got, setting
        unfrozen[setting] = sum(got.values())
    assert set(optim.LOAD_SETTING_FROZEN) == set(joptim.LOAD_SETTING_FROZEN)
    # the one-channel head whole: up1 (2 convs, 2 BNs), up2 (conv, BN), proj
    assert unfrozen["ft_semantic_head"] == (11 if 1 in num_classes else 0)


def test_config_groups_equal_the_yaml_files():
    for group, options in GROUPS.items():
        for option, cfg in options.items():
            path = os.path.join(CONFIG_DIR, group, option + ".yaml")
            assert cfg == load_yaml(path).to_dict(), (group, option)
    assert sorted(ROOTS) == ["depth", "distillation", "ssc_sam",
                             "traversability"]
    for name, cfg in ROOTS.items():
        root = load_yaml(os.path.join(CONFIG_DIR, name + ".yaml"))
        assert cfg == root.to_dict(), name


@pytest.mark.parametrize("argv", [
    [],
    ["trainer=smoke", "model=traversability/tiny", "dataset=synthetic_tiny"],
    ["trainer=standard_single", "model.batch_size=4",
     "model.optimizer.lr=1.0e-3", "trainer.ckpt_dir=/x/y", "+extra=[1, a]",
     "model.lr_scheduler.gamma=5e-1", "trainer.resume=true"],
])
def test_compose_cli_matches_jax(argv):
    assert compose_cli("traversability", argv).to_dict() == jcompose_cli(
        "traversability", CONFIG_DIR, argv).to_dict()


@pytest.mark.parametrize("argv", [
    [],
    ["trainer=smoke", "model=ssc_sam/tiny", "dataset=synthetic_tiny"],
    ["trainer=standard_single", "model.batch_size=4",
     "trainer.freeze_backbone_epochs=2", "model.load_setting=ft_decoders_all",
     "dataset.train.length=16"],
])
def test_compose_cli_ssc_matches_jax(argv):
    assert compose_cli("ssc_sam", argv).to_dict() == jcompose_cli(
        "ssc_sam", CONFIG_DIR, argv).to_dict()


@pytest.mark.parametrize("root, argv", [
    ("depth", []),
    ("depth", ["trainer=smoke", "dataset=synthetic_tiny", "model.batch_size=2",
               "model.vision_backbone.effnet_cfgs.stage_repeats=1"]),
    ("distillation", []),
    ("distillation", ["trainer=smoke", "model=distillation/tiny",
                      "dataset=synthetic_tiny"]),
    ("distillation", ["model=distillation/depth_only",
                      "dataset=synthetic_pefree", "model.batch_size=3"]),
])
def test_compose_cli_stage01_matches_jax(root, argv):
    assert compose_cli(root, argv).to_dict() == jcompose_cli(
        root, CONFIG_DIR, argv).to_dict()


def test_compose_cli_rejects_unknown_group():
    with pytest.raises(ValueError, match="Unknown config group"):
        compose_cli("traversability", ["trainr=smoke"])


@pytest.mark.parametrize("raw", [
    "5", "-3", "+3", "0", "017", "0x1F", "0b101", "1_000", "5e-4", "5.0e-4",
    "1.0e-07", "-1.5", "+1.5e+3", ".5", "1.", "-.inf", "true", "True",
    "FALSE", "yes", "off", "null", "~", "", "[a, b]", "[1, 2.5, x]",
    "[1, [2, 3]]", "[]", "'q'", "'it''s'", '"q r"', "abc", "a b",
    "/tmp/x", "traversability/tiny", "1e-4.0", "12.8", "[512, 612]",
])
def test_parse_value_matches_yaml(raw):
    got, want = parse_value(raw), yaml.safe_load(raw)
    assert got == want and type(got) is type(want)


def test_epoch_loader_matches_jax_bit_for_bit():
    cfg = GROUPS["dataset"]["synthetic_tiny"]
    ours = EpochLoader(build_dataset(cfg, "train"), 2, seed=5, num_workers=2)
    ref = JLoader(jbuild_dataset(JConfig(cfg), "train"), 2, seed=5,
                  num_workers=2)
    assert len(ours) == len(ref) == 2
    for epoch in (0, 1):
        a, b = list(ours.epoch(epoch)), list(ref.epoch(epoch))
        assert len(a) == len(b) == 2
        for x, y in zip(a, b):
            assert x.keys() == y.keys()
            for k in y:
                if isinstance(y[k], dict):
                    for kk in y[k]:
                        np.testing.assert_array_equal(x[k][kk], y[k][kk])
                else:
                    np.testing.assert_array_equal(x[k], y[k], err_msg=k)
                    assert x[k].dtype == y[k].dtype
    # the process-pool workers give the same batches
    proc = EpochLoader(build_dataset(cfg, "train"), 2, seed=5, num_workers=2,
                       worker_mode="process")
    try:
        for x, y in zip(proc.epoch(1), ref.epoch(1)):
            for k in y:
                np.testing.assert_equal(x[k], y[k], err_msg=k)
    finally:
        proc.close()


def _tiny_cfg(stage_repeats=2):
    cfg = presets.tiny_traversability_config().to_dict()
    cfg["vision_backbone"]["vision_backbone"]["effnet_cfgs"][
        "stage_repeats"] = stage_repeats
    cfg["batch_size"] = 2
    return cfg


def test_checkpoint_round_trip_and_stage_graft(tmp_path):
    cfg = _tiny_cfg()
    model, lm, state = pipelines.init_stage("traversability", cfg,
                                            steps_per_epoch=2, device="cpu")
    step = pipelines.make_train_step("traversability", model, lm)
    loader = EpochLoader(build_dataset(GROUPS["dataset"]["synthetic_tiny"],
                                       "train"), 2, num_workers=1)
    from creste_public_tpu_torch.training.loop import to_device

    step(state, to_device(next(iter(loader.epoch(0))), CPU),
         step_generator(0, 0))
    path = ckpt.save_checkpoint(str(tmp_path / "c"), state.step, state)
    assert path.endswith("step_1")
    assert ckpt.latest_checkpoint(str(tmp_path / "c")) == path
    _, _, fresh = pipelines.init_stage("traversability", cfg, seed=9,
                                       steps_per_epoch=2, device="cpu")
    ckpt.restore_checkpoint(path, fresh)
    assert fresh.step == 1
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[k], v), k
    assert fresh.optimizer.state_dict()["state"].keys() == \
        state.optimizer.state_dict()["state"].keys()
    assert fresh.scheduler.last_epoch == 1

    # a TerrainNet checkpoint grafts into the backbone; the head is kept
    tn = init_weights(TerrainNet(cfg["vision_backbone"]), 11)
    tn_dir = tmp_path / "tn" / "step_7"
    tn_dir.mkdir(parents=True)
    torch.save({"step": 7, "model": tn.state_dict()}, tn_dir / "state.pt")
    head = {k: v.clone() for k, v in fresh.model.state_dict().items()
            if k.startswith("traversability_head")}
    make_stage_loader("traversability", str(tmp_path / "tn"))(fresh)
    sd = fresh.model.state_dict()
    for k, v in tn.state_dict().items():
        assert torch.equal(sd[f"backbone.{k}"], v), k
    for k, v in head.items():
        assert torch.equal(sd[k], v), k
    # a same-stage checkpoint restores whole, except what ft_decoders_all
    # re-initialises
    before = {k: v.clone() for k, v in sd.items()}
    make_stage_loader("traversability", path, "ft_decoders_all")(fresh)
    for k, v in fresh.model.state_dict().items():
        keep = "bevclassifier" in k and "head_" in k
        assert torch.equal(v, before[k] if keep else
                           model.state_dict()[k]), k
    # a stage-3 checkpoint is no checkpoint of stage 0 and does not graft
    _, _, depth_state = pipelines.init_stage(
        "depth", jpresets.tiny_depth_config(), device="cpu")
    with pytest.raises(ValueError, match="own stage"):
        make_stage_loader("depth", path)(depth_state)


def _rows(d):
    return [json.loads(line) for line in open(os.path.join(d,
                                                           "metrics.jsonl"))]


def test_resume_continues_the_trajectory(tmp_path):
    """Four steps in one run against two steps plus a resumed run of two
    more (two steps per epoch): the same losses and the same final state,
    drop-connect active."""
    cfg = _tiny_cfg()
    ds_cfg = GROUPS["dataset"]["synthetic_tiny"]
    loader = EpochLoader(build_dataset(ds_cfg, "train"), 2, num_workers=1)
    base = {"max_epochs": 5, "log_every_n_steps": 1, "save_top_k": 1,
            "verbose": False, "steps_per_epoch": len(loader),
            "device": "cpu"}
    full = run_training("traversability", cfg, loader.epoch, None,
                        dict(base, max_steps=4, ckpt_dir=str(tmp_path / "a")))
    run_training("traversability", cfg, loader.epoch, None,
                 dict(base, max_steps=2, ckpt_dir=str(tmp_path / "b")))
    resumed = run_training("traversability", cfg, loader.epoch, None,
                           dict(base, max_steps=4, resume=True,
                                ckpt_dir=str(tmp_path / "b")))
    assert full.step == resumed.step == 4

    def losses(d):
        return {r["step"]: r["loss"] for r in _rows(d)
                if "split" not in r and "loss" in r}

    a, b = losses(tmp_path / "a"), losses(tmp_path / "b")
    assert sorted(a) == sorted(b) == [1, 2, 3, 4]
    assert a == b
    for k, v in full.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], v), k


def test_cli_metrics_keys_match_the_jax_cli(tmp_path, monkeypatch):
    """The port's CLI and the JAX package's, with the same arguments (one
    device, the trunk cut to one block per stage, and seeded weights of the
    init's shapes instead of the flax init run op by op, to keep the JAX
    side short), write metrics.jsonl lines with the same keys."""
    from creste_public_tpu.cli import train_from_config as jtrain

    init = JMaxEntIRL.init

    def seeded_init(self, rngs, *args, **kwargs):
        return jax_variables(seeded_variables(
            self, *args, init=lambda r, *a: init(self, r, *a, **kwargs)))

    monkeypatch.setattr(JMaxEntIRL, "init", seeded_init)
    argv = ["trainer=smoke", "model=traversability/tiny",
            "dataset=synthetic_tiny", "trainer.verbose=false",
            "trainer.devices=1",
            "model.vision_backbone.vision_backbone.effnet_cfgs."
            "stage_repeats=1"]
    state = train_traversability.main(
        argv + [f"trainer.ckpt_dir={tmp_path / 'port'}",
                "trainer.device=cpu"])
    jtrain(jcompose_cli("traversability", CONFIG_DIR,
                        argv + [f"trainer.ckpt_dir={tmp_path / 'jax'}"]))
    ours, ref = _rows(tmp_path / "port"), _rows(tmp_path / "jax")
    assert [sorted(r) for r in ours] == [sorted(r) for r in ref]
    assert [r.get("split") for r in ours] == [None, None, "train_epoch", "val"]
    assert all(np.isfinite(v) for r in ours for v in r.values()
               if isinstance(v, float))
    assert state.step == 2
    assert os.path.isfile(tmp_path / "port" / "step_2" / "state.pt")


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_training("traversability", _tiny_cfg(), [], None, {})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pipelines.init_stage("traversability", _tiny_cfg())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_traversability.main(["trainer=smoke",
                                   "model=traversability/tiny",
                                   "dataset=synthetic_tiny"])


def test_unported_options_raise(tmp_path):
    # validation images, once refused, are written as PNGs
    ds = build_dataset(GROUPS["dataset"]["synthetic_tiny"], "val")
    batches = [collate([ds[0], ds[1]])]
    run_training("traversability", _tiny_cfg(1), batches, lambda: batches,
                 {"device": "cpu", "log_val_images": True, "max_steps": 1,
                  "steps_per_epoch": 1, "verbose": False,
                  "ckpt_dir": str(tmp_path / "ckpt"),
                  "visuals_dir": str(tmp_path / "vis")})
    pngs = os.listdir(tmp_path / "vis")
    assert "irl_reward_with_expert_1.png" in pngs and len(pngs) >= 3
    with pytest.raises(ValueError, match="Unknown stage"):
        pipelines.build_model("stereo", {})
    # a compute_dtype is ported (the mixed-precision step): it builds
    model = pipelines.build_model("traversability", dict(
        GROUPS["model"]["traversability/tiny"], compute_dtype="bfloat16"))
    assert model.backbone.depthcomp.depthcomp.compute_dtype == torch.bfloat16
    # the CODa reader, once refused, reads a CODa tree
    write_coda_tree(str(tmp_path / "coda"), seqs=("0",), frames=2,
                    labels3d=False, scans=False, movability=False,
                    missing_sam=None)
    coda = build_dataset({"name": "coda", "root": str(tmp_path / "coda"),
                          "grid": 32, "map_range": 1.6, "horizon": 10},
                         "train", "cpu")
    assert isinstance(coda, CodaDataset) and len(coda) == 1
    assert coda[0]["image"].shape == (1, 64, 80, 4)
