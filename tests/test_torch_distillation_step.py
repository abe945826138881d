"""The port's stage 1 (``distillation``, the single-view
``DistillationBackbone``) against the JAX package on the CPU: the model in
eval and train mode, three chained training steps against
``pipelines.make_train_step("distillation")``, the ``train_pefree`` CLI's
metrics keys against the JAX CLI's, and the 1->2->3 weight flow through the
port's own checkpoints.

Setup: ``model=distillation/tiny`` with ``stage_repeats=2`` (5 residual
blocks, so drop-connect fires), B=2 batches of ``synthetic_tiny`` through
the JAX package's EpochLoader, seeded flax-shaped weights with jittered
BatchNorms, masks fed to both sides (``tests/test_torch_step_helpers.py``
says how and derives the step tolerances).

Tolerances: the model's outputs to FORWARD_RTOL of their largest entry
(f32 sums in another order); the step as the helpers state (METRIC_RTOL
1e-4, gradients by module in f32 to 5e-2 and per tensor in f64 to 1e-5);
keys, checkpoints and grafts exactly.
"""
import copy
import json
import os

import numpy as np
import pytest
import torch

from creste_public_tpu.config.config import compose_cli as jcompose_cli
from creste_public_tpu.models.distillation import (
    DistillationBackbone as JBackbone,
)
from creste_public_tpu_torch import train_pefree, train_ssc
from creste_public_tpu_torch import train_traversability
from creste_public_tpu_torch.config.groups import GROUPS
from creste_public_tpu_torch.data.dataloader import build_dataset
from creste_public_tpu_torch.data.synthetic import collate
from creste_public_tpu_torch.models.distillation import DistillationBackbone
from creste_public_tpu_torch.training import checkpoint as ckpt
from creste_public_tpu_torch.training import pipelines
from creste_public_tpu_torch.training.loop import to_device
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
KEYS = ("image", "p2p", "depth_label", "fimg_label")
N_MASKS = 5  # residual blocks of the b0 trunk at stage_repeats=2
TINY = ["trainer=smoke", "dataset=synthetic_tiny", "trainer.device=cpu",
        "trainer.verbose=false"]


@pytest.fixture(scope="module")
def distillation_run():
    cfg = copy.deepcopy(GROUPS["model"]["distillation/tiny"])
    cfg["vision_backbone"]["effnet_cfgs"]["stage_repeats"] = 2
    return jax_stage_run("distillation", cfg, tiny_batches(KEYS),
                         make_masks(N_MASKS, 2))


@pytest.mark.parametrize("train", [False, True])
def test_distillation_model_matches_flax(distillation_run, train):
    model = check_forward_matches_flax(distillation_run, train, FORWARD_RTOL)
    assert isinstance(model, DistillationBackbone)
    assert model.learnable_pe_map is None and model.cam2map is None


@pytest.mark.parametrize("t", range(STEPS))
def test_distillation_step_from_jax_state(distillation_run, t):
    check_step_from_jax_state(distillation_run, t)


def test_distillation_f64_gradient_matches_jax(distillation_run):
    check_f64_gradient(distillation_run)


def test_distillation_three_chained_steps(distillation_run):
    check_chained_steps(distillation_run)


def _rows(d):
    return [json.loads(line) for line in open(os.path.join(d,
                                                           "metrics.jsonl"))]


def test_train_pefree_cli_keys_match_the_jax_cli(tmp_path, monkeypatch):
    """``train_pefree`` and the JAX CLI with the same arguments (the trunk
    cut to one block per stage, seeded weights of the flax init's shapes
    on the JAX side) write metrics.jsonl lines with the same keys."""
    from creste_public_tpu.cli import train_from_config as jtrain

    init = JBackbone.init

    def seeded_init(self, rngs, *args, **kwargs):
        return jax_variables(seeded_variables(
            self, *args, init=lambda r, *a: init(self, r, *a, **kwargs)))

    monkeypatch.setattr(JBackbone, "init", seeded_init)
    argv = ["trainer=smoke", "model=distillation/tiny",
            "dataset=synthetic_tiny", "trainer.verbose=false",
            "trainer.devices=1",
            "model.vision_backbone.effnet_cfgs.stage_repeats=1"]
    state = train_pefree.main(argv + [f"trainer.ckpt_dir={tmp_path / 'port'}",
                                      "trainer.device=cpu"])
    jtrain(jcompose_cli("distillation", CONFIG_DIR,
                        argv + [f"trainer.ckpt_dir={tmp_path / 'jax'}"]))
    ours, ref = _rows(tmp_path / "port"), _rows(tmp_path / "jax")
    assert [sorted(r) for r in ours] == [sorted(r) for r in ref]
    assert [r.get("split") for r in ours] == [None, None, "train_epoch", "val"]
    assert all(np.isfinite(v) for r in ours for v in r.values()
               if isinstance(v, float))
    assert state.step == 2


def _same(a: dict, b: dict, prefix: str = "") -> None:
    for k, v in a.items():
        assert torch.equal(b[prefix + k], v), k


def test_three_stage_weight_flow(tmp_path):
    """The 1->2->3 flow through the port's own checkpoints and entry points
    (the JAX package's ``test_three_stage_weight_flow``): ``train_pefree``
    writes a checkpoint that restores; ``make_stage_loader("ssc")`` grafts
    it into TerrainNet's ``depthcomp`` tensor for tensor, and the grafted
    model runs; ``train_ssc model.weights_path=<it>`` with the backbone
    frozen for its one epoch (zero gradients from zero moments: Adam
    leaves the parameters bit-still) keeps the graft's parameters in its
    own checkpoint; ``train_traversability model.weights_path=<that>``
    grafts stage 2 into ``backbone``, which it keeps frozen."""
    s1, s2, s3 = (str(tmp_path / f"s{i}") for i in (1, 2, 3))
    stage1 = train_pefree.main(TINY + ["model=distillation/tiny",
                                       f"trainer.ckpt_dir={s1}"])
    raw1 = ckpt.load_state_file(ckpt.latest_checkpoint(s1))["model"]
    _same(stage1.model.state_dict(), raw1)

    cfg2 = GROUPS["model"]["ssc_sam/tiny"]
    model2, _, state2 = pipelines.init_stage("ssc", cfg2, device="cpu")
    make_stage_loader("ssc", s1)(state2)
    sd2 = model2.state_dict()
    _same(raw1, sd2, "depthcomp.")
    ds = build_dataset(GROUPS["dataset"]["synthetic_tiny"], "val")
    batch = to_device(collate([ds[i] for i in range(2)]), CPU)
    model2.eval()
    with torch.no_grad():
        out = model2(batch["image"], batch["p2p"])
    assert torch.isfinite(out["inpainting_sam_preds"]).all()

    stage2 = train_ssc.main(TINY + [
        "model=ssc_sam/tiny", f"trainer.ckpt_dir={s2}",
        f"model.weights_path={s1}", "trainer.freeze_backbone_epochs=1"])
    raw2 = ckpt.load_state_file(ckpt.latest_checkpoint(s2))["model"]
    _same(stage2.model.state_dict(), raw2)
    _same({k: v for k, v in raw1.items() if "running" not in k}, raw2,
          "depthcomp.")

    cfg3 = GROUPS["model"]["traversability/tiny"]
    model3, _, state3 = pipelines.init_stage("traversability", cfg3,
                                             device="cpu")
    make_stage_loader("traversability", s2, "strict_freeze")(state3)
    _same(raw2, model3.state_dict(), "backbone.")
    model3.eval()
    with torch.no_grad():
        out = model3(batch["image"], batch["p2p"],
                     batch["traversability_label"])
    assert torch.isfinite(out["traversability_preds"]).all()
    assert "exp_svf" in out

    stage3 = train_traversability.main(TINY + [
        "model=traversability/tiny", f"trainer.ckpt_dir={s3}",
        f"model.weights_path={s2}"])
    _same({k: v for k, v in raw2.items() if "running" not in k},
          stage3.model.state_dict(), "backbone.")


def test_distillation_checkpoint_resumes(distillation_run, tmp_path):
    """A stage-1 checkpoint restores whole into stage 1 through
    ``weights_path``."""
    model, _, state = port_model(distillation_run)
    ckpt.save_checkpoint(str(tmp_path / "s1"), 3, state)
    _, _, fresh = pipelines.init_stage(
        "distillation", distillation_run["cfg"], seed=4, device="cpu")
    make_stage_loader("distillation", str(tmp_path / "s1"))(fresh)
    _same(model.state_dict(), fresh.model.state_dict())
