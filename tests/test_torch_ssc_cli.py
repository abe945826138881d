"""The stage-2 entry point and loop of the port on the CPU: the CLI's
metrics keys against the JAX CLI's, ``grad_norm`` under a load setting
that freezes parameters against the JAX step's, the epoch-scheduled freeze
through the loop, and the default device.

The trunk is cut to one block per stage (``stage_repeats=1``: no residual
block, so no drop-connect mask) to keep the JAX compiles short.
"""
import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict
from jax.sharding import NamedSharding, PartitionSpec as P

from creste_public_tpu.config.config import Config as JConfig
from creste_public_tpu.config.config import compose_cli as jcompose_cli
from creste_public_tpu.data.dataloader import EpochLoader as JLoader
from creste_public_tpu.data.dataloader import build_dataset as jbuild_dataset
from creste_public_tpu.losses import LossManager as JLossManager
from creste_public_tpu.models.terrainnet import TerrainNet as JTerrainNet
from creste_public_tpu.parallel import make_mesh, shard_batch
from creste_public_tpu.training import optim as joptim
from creste_public_tpu.training import pipelines as jpipelines
from creste_public_tpu.training.state import TrainState as JTrainState
from creste_public_tpu_torch import train_ssc
from creste_public_tpu_torch.config.groups import GROUPS
from creste_public_tpu_torch.data.dataloader import EpochLoader, build_dataset
from creste_public_tpu_torch.training import optim, pipelines
from creste_public_tpu_torch.training.loop import run_training, to_device
from creste_public_tpu_torch.training.state import global_norm
from creste_public_tpu_torch.weights import from_jax_variables
from tests.test_torch_helpers import jax_variables, jitter_bn, seeded_variables
from tests.test_torch_step_helpers import (
    one_torch_thread,  # noqa: F401 (an autouse fixture)
)

CONFIG_DIR = os.path.join(os.path.dirname(__file__), "..", "configs")
CPU = torch.device("cpu")
TRUNK = "model.vision_backbone.effnet_cfgs.stage_repeats=1"
# the port's grad_norm against JAX's: the end-to-end gradient of the tiny
# preset is ill-conditioned (tests/test_torch_ssc_step.py measures JAX's
# own gradient moving by up to ~1e-1 of a decoder tensor under a 1e-6
# input perturbation); its norm over every tensor moves far less
GRAD_NORM_RTOL = 2e-2


def _tiny_cfg() -> dict:
    cfg = copy.deepcopy(GROUPS["model"]["ssc_sam/tiny"])
    cfg["vision_backbone"]["effnet_cfgs"]["stage_repeats"] = 1
    return cfg


def _rows(d):
    return [json.loads(line) for line in open(os.path.join(d,
                                                           "metrics.jsonl"))]


def test_cli_metrics_keys_match_the_jax_cli(tmp_path, monkeypatch):
    """``train_ssc`` and the JAX package's CLI, with the same arguments,
    write metrics.jsonl lines with the same keys (JAX with seeded weights
    of the init's shapes, to skip its op-by-op init)."""
    from creste_public_tpu.cli import train_from_config as jtrain

    init = JTerrainNet.init

    def seeded_init(self, rngs, *args, **kwargs):
        return jax_variables(seeded_variables(
            self, *args, init=lambda r, *a: init(self, r, *a, **kwargs)))

    monkeypatch.setattr(JTerrainNet, "init", seeded_init)
    argv = ["trainer=smoke", "model=ssc_sam/tiny", "dataset=synthetic_tiny",
            "trainer.verbose=false", "trainer.devices=1", TRUNK]
    state = train_ssc.main(argv + [f"trainer.ckpt_dir={tmp_path / 'port'}",
                                   "trainer.device=cpu"])
    jtrain(jcompose_cli("ssc_sam", CONFIG_DIR,
                        argv + [f"trainer.ckpt_dir={tmp_path / 'jax'}"]))
    ours, ref = _rows(tmp_path / "port"), _rows(tmp_path / "jax")
    assert [sorted(r) for r in ours] == [sorted(r) for r in ref]
    assert [r.get("split") for r in ours] == [None, None, "train_epoch", "val"]
    assert "SupPixelConLoss/joint/3d_sam_label/supcon/sem_loss" in ours[0]
    assert "CrossEntropyDepth/depth/acc" in ours[-1]
    assert all(np.isfinite(v) for r in ours for v in r.values()
               if isinstance(v, float))
    assert state.step == 2
    assert os.path.isfile(tmp_path / "port" / "step_2" / "state.pt")


def test_grad_norm_counts_frozen_parameters_as_jax_does():
    """Under ``ft_decoders_all`` only the decoder heads train, but the JAX
    step's grad_norm runs over every gradient before optax's mask zeroes
    the frozen ones' updates: the port's matches it, while the norm over
    the trainable parameters alone is far off. Both sides leave the frozen
    parameters unchanged."""
    cfg = _tiny_cfg()
    ds = jbuild_dataset(JConfig(GROUPS["dataset"]["synthetic_tiny"]),
                        "train")
    batch = next(iter(JLoader(ds, 2, seed=0, num_workers=1).epoch(0)))
    jm = JTerrainNet(cfg)
    flat = jitter_bn(seeded_variables(jm, batch["image"], batch["p2p"]))
    pri = np.random.default_rng(8).uniform(
        size=batch["3d_sam_label"].size).astype(np.float32)
    pred = joptim.LOAD_SETTING_FROZEN["ft_decoders_all"]
    variables = jax_variables(flat)
    tx = joptim.make_optimizer(
        cfg["optimizer"], cfg["lr_scheduler"], 2,
        trainable_mask=joptim.freeze_mask(variables["params"], pred))
    mesh = make_mesh(1)
    state = jax.device_put(
        JTrainState.create(variables["params"], variables["batch_stats"], tx),
        NamedSharding(mesh, P()))
    step = jpipelines.make_train_step("ssc", jm, JLossManager(cfg), tx, mesh,
                                      task="joint", donate=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "uniform",
                   lambda key, shape, *a, **k: jnp.asarray(pri))
        new_state, jm_ = step(state, shard_batch(batch, mesh),
                              jax.random.PRNGKey(0))
    want = float(jm_["grad_norm"])

    model, lm, pstate = pipelines.init_stage(
        "ssc", cfg, steps_per_epoch=2, device="cpu",
        frozen_pred=optim.LOAD_SETTING_FROZEN["ft_decoders_all"])
    model.load_state_dict(from_jax_variables(flat), strict=True)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    step = pipelines.make_train_step("ssc", model, lm, task="joint")
    metrics = step(pstate, to_device(batch, CPU), torch.Generator(),
                   priorities=torch.from_numpy(pri))
    got = float(metrics["grad_norm"])
    np.testing.assert_allclose(got, want, rtol=GRAD_NORM_RTOL)
    named = dict(model.named_parameters())
    frozen = optim.LOAD_SETTING_FROZEN["ft_decoders_all"]
    trainable = [k for k in named if not frozen(k)]
    assert trainable and all("head_" in k for k in trainable)
    heads_only = float(global_norm([named[k].grad for k in trainable]))
    assert abs(heads_only - want) > 10 * GRAD_NORM_RTOL * want
    want_p = from_jax_variables({
        f"params/{k}": np.asarray(v)
        for k, v in flatten_dict(new_state.params, sep="/").items()})
    after = model.state_dict()
    for k in named:
        if k not in trainable:
            assert torch.equal(after[k], before[k]), k
            assert torch.equal(want_p[k], before[k]), k


def test_loop_scheduled_freeze(tmp_path):
    """freeze_backbone_epochs=1 over two epochs of one step: the first
    epoch's gate is 0 (the backbone stays bit-unchanged, the rest moves,
    Adam counts the step for every parameter), the second's 1."""
    cfg = _tiny_cfg()
    loader = EpochLoader(build_dataset(GROUPS["dataset"]["synthetic_tiny"],
                                       "train"), 4, num_workers=1)
    base = {"max_epochs": 1, "log_every_n_steps": 1, "save_top_k": 1,
            "verbose": False, "steps_per_epoch": len(loader),
            "device": "cpu", "freeze_backbone_epochs": 1}
    init = pipelines.init_stage("ssc", cfg, steps_per_epoch=1,
                                device="cpu")[0].state_dict()
    one = run_training("ssc", cfg, loader.epoch, None,
                       dict(base, ckpt_dir=str(tmp_path / "a")), task="joint")
    two = run_training("ssc", cfg, loader.epoch, None,
                       dict(base, max_epochs=2, ckpt_dir=str(tmp_path / "b")),
                       task="joint")
    sd1, sd2 = one.model.state_dict(), two.model.state_dict()
    for k, v in init.items():
        if "running" in k or "num_batches" in k:
            continue
        if k.startswith("depthcomp."):
            assert torch.equal(sd1[k], v), k
        else:
            assert not torch.equal(sd1[k], v), k
    assert any(not torch.equal(sd2[k], v) for k, v in init.items()
               if k.startswith("depthcomp.") and "running" not in k)
    assert {int(s["step"]) for s in one.optimizer.state.values()} == {1}
    assert {int(s["step"]) for s in two.optimizer.state.values()} == {2}
    rows = [r for r in _rows(tmp_path / "b") if "split" not in r]
    assert [r["step"] for r in rows] == [1, 2]


def test_train_ssc_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_ssc.main(["trainer=smoke", "model=ssc_sam/tiny",
                        "dataset=synthetic_tiny"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pipelines.init_stage("ssc", _tiny_cfg())
