"""The port's validation images against the JAX package's.

* ``render_stage_outputs`` gives JAX's tags and images for the same numpy
  outputs of stage 2 and stage 3, exactly, except ``bev/elevation_3d``
  (drawn with PIL, not matplotlib: the shape only).
* ``train_ssc`` and ``train_traversability`` run through ``main`` with
  ``dataset=coda visualize=effnet_distillation`` at the tiny preset (one
  block per trunk stage), on a synthesized CODa tree, on the CPU, one step
  each: the losses are finite, and the PNGs under ``visualize.save_dir``
  are one per tag that JAX's ``render_stage_outputs`` gives for the port
  model's eval outputs on the first validation sample.
"""
from __future__ import annotations

import json
import math
import os

import numpy as np
import pytest
import torch
from PIL import Image

from creste_public_tpu.training import visual_log as jvl
from creste_public_tpu_torch import train_ssc, train_traversability
from creste_public_tpu_torch.data.dataloader import build_dataset
from creste_public_tpu_torch.data.synthetic import collate
from creste_public_tpu_torch.config.groups import compose_cli
from creste_public_tpu_torch.training import checkpoint as ckpt
from creste_public_tpu_torch.training import pipelines
from creste_public_tpu_torch.training import visual_log as vl
from creste_public_tpu_torch.training.loop import to_device
from tests.test_torch_coda_tree import write_coda_tree
from tests.test_torch_step_helpers import one_torch_thread  # noqa: F401

R = np.random.default_rng


def _outputs(stage: str) -> dict:
    g, hv, wv = 16, 8, 16
    if stage == "ssc":
        return {
            "depth_preds_metric": R(0).uniform(0, 30, (1, 24, 30)),
            "inpainting_sam_preds": R(1).normal(size=(1, g, g, 8)),
            "inpainting_sam_dynamic_preds": R(2).normal(size=(1, g, g, 6)),
            "elevation_preds": R(3).normal(size=(1, g, g, 2)),
        }
    p = R(6).uniform(size=(1, hv, wv, 8))
    return {
        "traversability_preds": R(4).normal(size=(1, hv, wv, 1)),
        "exp_svf": np.abs(R(5).normal(size=(1, hv, wv))),
        "policy": p / p.sum(-1, keepdims=True),
    }


def _batch(stage: str) -> dict:
    g = 16
    if stage == "ssc":
        depth = R(7).uniform(0, 30000, (1, 1, 24, 30))
        return {
            "depth_label": depth.astype(np.float32),
            "3d_sam_label": R(8).integers(0, 9, (1, g, g)),
            "3d_sam_dynamic_label": R(9).integers(0, 6, (1, g, g, 3))
            .astype(np.float32),
            "elevation_label": R(10).normal(size=(1, g, g, 2)),
        }
    expert = np.tile(np.eye(3, dtype=np.float32), (1, 6, 1, 1))
    expert[0, :, 0, 2] = np.linspace(15, 3, 6)
    expert[0, :, 1, 2] = np.linspace(16, 22, 6)
    return {"traversability_label": expert}


@pytest.mark.parametrize("stage", ["ssc", "traversability"])
@pytest.mark.parametrize("with_labels", [True, False])
def test_render_stage_outputs_equals_jax(stage, with_labels):
    outputs = _outputs(stage)
    batch = _batch(stage) if with_labels else {}
    got = vl.render_stage_outputs(stage, outputs, batch)
    want = jvl.render_stage_outputs(stage, outputs, batch)
    assert list(got) == list(want)
    for tag in want:
        assert got[tag].dtype == want[tag].dtype == np.uint8
        assert got[tag].shape == want[tag].shape, tag
        if tag != "bev/elevation_3d":
            assert np.array_equal(got[tag], want[tag]), tag


@pytest.fixture(scope="module")
def coda_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("coda"))
    write_coda_tree(root, frames=3, labels3d=False, scans=False,
                    missing_sam=None)
    return root


def _argv(model: str, root: str, out: str) -> list[str]:
    trunk = ("model.vision_backbone.vision_backbone" if "traversability"
             in model else "model.vision_backbone")
    return ["trainer=smoke", f"model={model}", "dataset=coda",
            "visualize=effnet_distillation", f"dataset.root={root}",
            "dataset.grid=32", "dataset.map_range=1.6", "dataset.horizon=10",
            "trainer.max_steps=1", "trainer.device=cpu",
            "trainer.verbose=false", "trainer.num_workers=2",
            f"{trunk}.effnet_cfgs.stage_repeats=1",
            f"trainer.ckpt_dir={out}/ckpt", f"visualize.save_dir={out}/vis"]


@pytest.mark.parametrize("stage,root_cfg,model,main", [
    ("ssc", "ssc_sam", "ssc_sam/tiny", train_ssc.main),
    ("traversability", "traversability", "traversability/tiny",
     train_traversability.main),
])
def test_coda_training_writes_the_jax_tags(coda_root, tmp_path, stage,
                                           root_cfg, model, main):
    argv = _argv(model, coda_root, str(tmp_path))
    state = main(argv)
    assert state.step == 1
    with open(tmp_path / "ckpt" / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    losses = [r["loss"] for r in rows if "loss" in r]
    assert losses and all(math.isfinite(v) for v in losses)
    assert any(r.get("split") == "val" for r in rows)

    cfg = compose_cli(root_cfg, argv)
    ds = build_dataset(cfg["dataset"], "val", "cpu")
    batch = collate([ds[i] for i in range(min(2, len(ds)))])
    model_, _, _ = pipelines.init_stage(stage, cfg["model"],
                                            device="cpu")
    model_.load_state_dict(ckpt.load_state_file(
        ckpt.latest_checkpoint(str(tmp_path / "ckpt")))["model"])
    model_.eval()
    first = to_device(vl._first(batch), torch.device("cpu"))
    with torch.no_grad():
        out = model_(*pipelines.model_inputs(stage, first))
    outputs = {k: v.numpy() for k, v in out.items()
               if isinstance(v, torch.Tensor)}
    tags = jvl.render_stage_outputs(stage, outputs, batch)
    assert {"depth/pred_vs_gt", "bev/elevation_3d",
            "irl/reward_with_expert" if stage == "traversability"
            else "bev/sam_pred_vs_gt"} <= set(tags)
    want = {f"{t.replace('/', '_')}_1.png" for t in tags}
    assert set(os.listdir(tmp_path / "vis")) == want
    for name in want:
        img = np.asarray(Image.open(tmp_path / "vis" / name))
        assert img.dtype == np.uint8 and img.ndim == 3 and img.std() > 0
