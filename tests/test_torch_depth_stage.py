"""The port's stage 0 (``depth``, ``DepthCompletionModel``) against the JAX
package on the CPU: the model in eval and train mode, three chained
training steps against ``pipelines.make_train_step("depth")``, the
``train_depth`` CLI's metrics keys against the JAX CLI's, stage-0
checkpoints, and the eval step of every stage.

Setup: ``presets.tiny_depth_config`` with ``stage_repeats=2`` (5 residual
blocks, so drop-connect fires; the preset's 1 has none), B=2 batches of the
``synthetic_tiny`` dataset through the JAX package's EpochLoader, seeded
flax-shaped weights with jittered BatchNorms, masks fed to both sides
(``tests/test_torch_step_helpers.py`` says how and derives the step
tolerances).

Tolerances: the model's outputs to FORWARD_RTOL of their largest entry
(f32 sums in another order through the EfficientNet trunk; they read ~1e-5
and below); the step as the helpers state (METRIC_RTOL 1e-4, gradients by
module in f32 to 5e-2 and per tensor in f64 to 1e-5); the CLI's keys and
the checkpoints exactly.
"""
import json
import os

import numpy as np
import pytest
import torch

from creste_public_tpu.config.config import compose_cli as jcompose_cli
from creste_public_tpu.models.depth_completion import (
    DepthCompletionModel as JDepthModel,
)
from creste_public_tpu_torch import train_depth
from creste_public_tpu_torch.config import presets
from creste_public_tpu_torch.config.groups import GROUPS
from creste_public_tpu_torch.data.dataloader import build_dataset
from creste_public_tpu_torch.data.synthetic import collate
from creste_public_tpu_torch.models.depth_completion import (
    DepthCompletionModel,
)
from creste_public_tpu_torch.training import checkpoint as ckpt
from creste_public_tpu_torch.training import pipelines
from creste_public_tpu_torch.training.loop import make_eval_step, to_device
from creste_public_tpu_torch.training.surgery import make_stage_loader
from tests.test_torch_helpers import jax_variables, seeded_variables
from tests.test_torch_step_helpers import (
    one_torch_thread,  # noqa: F401 (an autouse fixture)
    CPU,
    STEPS,
    check_chained_steps,
    check_f64_gradient,
    check_forward_matches_flax,
    check_step_from_jax_state,
    jax_stage_run,
    make_masks,
    port_model,
    tiny_batches,
)

CONFIG_DIR = os.path.join(os.path.dirname(__file__), "..", "configs")
FORWARD_RTOL = 1e-4
KEYS = ("image", "p2p", "depth_label")
N_MASKS = 5  # residual blocks of the b0 trunk at stage_repeats=2


@pytest.fixture(scope="module")
def depth_run():
    cfg = presets.tiny_depth_config().to_dict()
    cfg["vision_backbone"]["effnet_cfgs"]["stage_repeats"] = 2
    return jax_stage_run("depth", cfg, tiny_batches(KEYS),
                         make_masks(N_MASKS, 2))


@pytest.mark.parametrize("train", [False, True])
def test_depth_model_matches_flax(depth_run, train):
    """DepthCompletionModel from the JAX state before the first step, in
    eval mode and in train mode with the same masks (with its staged
    running statistics)."""
    model = check_forward_matches_flax(depth_run, train, FORWARD_RTOL)
    assert isinstance(model, DepthCompletionModel)


@pytest.mark.parametrize("t", range(STEPS))
def test_depth_step_from_jax_state(depth_run, t):
    check_step_from_jax_state(depth_run, t)


def test_depth_f64_gradient_matches_jax(depth_run):
    check_f64_gradient(depth_run)


def test_depth_three_chained_steps(depth_run):
    check_chained_steps(depth_run)


def _rows(d):
    return [json.loads(line) for line in open(os.path.join(d,
                                                           "metrics.jsonl"))]


def test_train_depth_cli_keys_match_the_jax_cli(tmp_path, monkeypatch):
    """``train_depth`` and the JAX CLI with the same arguments (the
    published ``depth_only`` model narrowed by overrides, its trunk cut to
    one block per stage, seeded weights of the flax init's shapes on the
    JAX side) write metrics.jsonl lines with the same keys, and the port's
    ``step_2`` checkpoint restores."""
    from creste_public_tpu.cli import train_from_config as jtrain

    init = JDepthModel.init

    def seeded_init(self, rngs, *args, **kwargs):
        return jax_variables(seeded_variables(
            self, *args, init=lambda r, *a: init(self, r, *a, **kwargs)))

    monkeypatch.setattr(JDepthModel, "init", seeded_init)
    argv = ["trainer=smoke", "dataset=synthetic_tiny", "model.batch_size=2",
            "trainer.verbose=false", "trainer.devices=1",
            "model.vision_backbone.effnet_cfgs.stage_repeats=1",
            "model.vision_backbone.effnet_cfgs.out_channels=32",
            "model.vision_backbone.effnet_cfgs.image_size=[64, 80]",
            "model.depth_head.dims=[32, 128]"]
    state = train_depth.main(argv + [f"trainer.ckpt_dir={tmp_path / 'port'}",
                                     "trainer.device=cpu"])
    jtrain(jcompose_cli("depth", CONFIG_DIR,
                        argv + [f"trainer.ckpt_dir={tmp_path / 'jax'}"]))
    ours, ref = _rows(tmp_path / "port"), _rows(tmp_path / "jax")
    assert [sorted(r) for r in ours] == [sorted(r) for r in ref]
    assert [r.get("split") for r in ours] == [None, None, "train_epoch", "val"]
    assert all(np.isfinite(v) for r in ours for v in r.values()
               if isinstance(v, float))
    assert state.step == 2
    path = ckpt.latest_checkpoint(str(tmp_path / "port"))
    assert path.endswith("step_2")
    cfg = train_depth_cfg(argv)
    _, _, fresh = pipelines.init_stage("depth", cfg, seed=3, device="cpu")
    ckpt.restore_checkpoint(path, fresh)
    for k, v in state.model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[k], v), k


def train_depth_cfg(argv):
    from creste_public_tpu_torch.config.groups import compose_cli

    return compose_cli("depth", argv)["model"]


def test_depth_checkpoints_resume_and_refuse_other_stages(depth_run,
                                                          tmp_path):
    """A stage-0 checkpoint restores whole into stage 0 (``weights_path``);
    a stage-1 one does not (stage 0 has no submodule to graft into), and a
    stage-0 one does not graft into stage 1 either: the JAX package would
    restore either tree whole and then fail."""
    run = depth_run
    model, _, state = port_model(run)
    d0 = ckpt.save_checkpoint(str(tmp_path / "s0"), 4, state)
    _, _, fresh = pipelines.init_stage("depth", run["cfg"], seed=5,
                                       device="cpu")
    make_stage_loader("depth", str(tmp_path / "s0"))(fresh)
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[k], v), k

    cfg1 = presets.tiny_distillation_config().to_dict()
    _, _, s1 = pipelines.init_stage("distillation", cfg1, device="cpu")
    before = {k: v.clone() for k, v in s1.model.state_dict().items()}
    with pytest.raises(ValueError, match="own stage"):
        make_stage_loader("distillation", d0)(s1)
    for k, v in s1.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    d1 = ckpt.save_checkpoint(str(tmp_path / "s1"), 2, s1)
    with pytest.raises(ValueError, match="own stage"):
        make_stage_loader("depth", d1)(fresh)


@pytest.mark.parametrize("stage, model_group", [
    ("depth", None),
    ("distillation", "distillation/tiny"),
    ("ssc", "ssc_sam/tiny"),
    ("traversability", "traversability/tiny"),
])
def test_eval_step_runs_for_every_stage(stage, model_group):
    """``loop.make_eval_step`` of each stage on one ``synthetic_tiny``
    batch gives finite metrics, ``loss`` among them (stages 0 and 1 take an
    empty ``aux``; only stage 2 draws SupCon's priorities), in eval
    mode."""
    if model_group is None:
        cfg = presets.tiny_depth_config().to_dict()
    else:
        cfg = GROUPS["model"][model_group]
    model, lm, _ = pipelines.init_stage(stage, cfg, device="cpu")
    ds = build_dataset(GROUPS["dataset"]["synthetic_tiny"], "val")
    batch = to_device(collate([ds[i] for i in range(2)]), CPU)
    metrics = make_eval_step(stage, model, lm,
                             "joint" if stage == "ssc" else None)(batch)
    assert "loss" in metrics and len(metrics) > 1
    assert all(np.isfinite(v) for v in metrics.values())
    assert not model.training
