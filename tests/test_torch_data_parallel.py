"""The port's data-parallel training on the CPU: two spawned ranks in a gloo
group (``tests/test_torch_dp_ranks.py``).

``test_two_rank_step_equals_serial_emulation``: one stage-2 step (the six
losses, SupCon's anchors on each rank against the features gathered from
both) and one stage-3 step (VI, SVF and the IRL penalty per rank), each at
the tiny preset on a global B=4 batch of ``synthetic_tiny`` (2 rows per
rank) with per-rank drop-connect masks and SupCon priorities fed, against
the serial emulation in this process: the reduced gradients per tensor, the
parameters and running statistics after the step, and the metrics, to
float-reduction precision (EMULATION_RTOL of the tensor's largest entry:
the ranks add the two halves' gradients in another order than one
backward does). Both ranks end bit-equal.

``test_bn_stats_are_the_only_layout_dependence``: the two-rank step
against the one-process B=4 step from the same state (the JAX package's
test of the same name): they differ, by at most an Adam step per entry
(the BatchNorms' batch statistics are per rank), and with the batch
statistics out of the picture (eval mode) the forward does not depend on
the layout.

``test_rank_rows_equal_jax_sharded_batch``: each rank's loader rows equal
the rows that the JAX loop's ``_pad_to_multiple`` and ``shard_batch`` put
on that device of a 2-device mesh, bit for bit, augmented, and on a
partial last validation batch.

``test_only_rank_zero_writes``: the stage-3 command with
``trainer.devices=2`` on the CPU starts its two ranks; ``metrics.jsonl``
holds every line once and the checkpoints are rank 0's; the ranks' final
states are equal (the checkpoint restores into either).
"""
import copy
import json
import os

import numpy as np
import pytest
import torch

from creste_public_tpu.config.config import Config as JConfig
from creste_public_tpu.data.augment import augment_sample as jaugment
from creste_public_tpu.data.dataloader import EpochLoader as JLoader
from creste_public_tpu.data.dataloader import build_dataset as jbuild_dataset
from creste_public_tpu.parallel import make_mesh
from creste_public_tpu.parallel import shard_batch as jshard_batch
from creste_public_tpu.training.loop import _pad_to_multiple
from creste_public_tpu_torch import train_traversability, weights
from creste_public_tpu_torch.config.groups import GROUPS
from creste_public_tpu_torch.data.augment import augment_sample
from creste_public_tpu_torch.data.dataloader import EpochLoader, build_dataset
from creste_public_tpu_torch.models.blocks.convnets import eval_form
from creste_public_tpu_torch.training import checkpoint as ckpt
from creste_public_tpu_torch.training import pipelines
from creste_public_tpu_torch.training.loop import run_training, to_device
from tests.test_torch_dp_ranks import (
    Feeder,
    build,
    dp_steps,
    make_masks,
    run_ranks,
    serial_emulation,
)
from tests.test_torch_step_helpers import one_torch_thread  # noqa: F401

WORLD = 2
B = 4  # global batch: 2 rows per rank
N_MASKS = 9  # residual blocks of the tiny presets' full trunk
EMULATION_RTOL = 1e-6
LR = 5e-4  # both tiny presets' Adam learning rate
CASES = {
    "ssc": ("ssc_sam/tiny", "joint"),
    "traversability": ("traversability/tiny", None),
}


def _global_batch() -> dict:
    ds = build_dataset(GROUPS["dataset"]["synthetic_tiny"], "train")
    return next(EpochLoader(ds, B, shuffle=False, num_workers=1).epoch(0))


def _case(stage: str) -> dict:
    model_name, task = CASES[stage]
    cfg = copy.deepcopy(GROUPS["model"][model_name])
    batch = _global_batch()
    model = weights.init_weights(pipelines.build_model(stage, cfg), 3)
    masks = [make_masks(N_MASKS, B // WORLD, seed=10 + r)
             for r in range(WORLD)]
    pri = None
    if stage == "ssc":
        n = batch["3d_sam_label"][:B // WORLD].size
        pri = [np.random.default_rng(20 + r).uniform(size=n).astype(
            np.float32) for r in range(WORLD)]
    return dict(stage=stage, cfg=cfg, weights=model.state_dict(),
                batch=batch, masks=masks, pri=pri, task=task)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cases = [_case(stage) for stage in CASES]
    ranks = run_ranks(dp_steps, WORLD,
                      tmp_path_factory.mktemp("dp"), cases)
    return {c["stage"]: dict(case=c, ranks=[r[i] for r in ranks])
            for i, c in enumerate(cases)}


def _close(got: torch.Tensor, want: torch.Tensor, rtol: float, what: str):
    scale = max(float(want.abs().max()), 1e-12) if want.numel() else 1.0
    d = float((got - want).abs().max()) if want.numel() else 0.0
    assert d <= rtol * scale, (what, d, scale)


@pytest.mark.parametrize("stage", list(CASES))
def test_two_rank_step_equals_serial_emulation(runs, stage):
    c, (r0, r1) = runs[stage]["case"], runs[stage]["ranks"]
    assert r0["step"] == r1["step"] == 1
    # the replicated state stays replicated
    for k, v in r0["state"].items():
        assert torch.equal(v, r1["state"][k]), k
    for k, v in r0["grads"].items():
        assert torch.equal(v, r1["grads"][k]), k
    assert r0["metrics"] == r1["metrics"]

    emu = serial_emulation(c["stage"], c["cfg"], c["weights"], c["batch"],
                           c["masks"], c["pri"], c["task"], WORLD)
    assert r0["grads"].keys() == emu["grads"].keys()
    moved = 0
    for k, g in emu["grads"].items():
        _close(r0["grads"][k], g, EMULATION_RTOL, f"gradient {k}")
        moved += bool(g.abs().max() > 0)
    assert moved > 10
    for k, v in emu["state"].items():
        if v.is_floating_point():
            _close(r0["state"][k], v, EMULATION_RTOL, f"state {k}")
        else:
            assert torch.equal(r0["state"][k], v), k
    # the running statistics moved with the step, to the ranks' mean
    start = c["weights"]
    stats = [k for k in emu["state"] if "running" in k]
    assert stats and any(not torch.equal(emu["state"][k], start[k])
                         for k in stats)
    for k, v in emu["metrics"].items():
        if "supcon" in k:
            continue  # the emulation adds SupCon outside its closure
        assert r0["metrics"][k] == pytest.approx(v, rel=1e-5, abs=1e-7), k
    if stage == "ssc":
        assert emu["supcon"] and all(
            np.isfinite(v) and v != 0 for _, v in emu["supcon"].values())
        key = [k for k in r0["metrics"] if k.endswith("supcon/sem_loss")][0]
        assert np.isfinite(r0["metrics"][key]) and r0["metrics"][key] != 0


def test_bn_stats_are_the_only_layout_dependence(runs):
    c, (r0, _) = runs["ssc"]["case"], runs["ssc"]["ranks"]
    model, lm, state = build(c["stage"], c["cfg"], c["weights"])
    step = pipelines.make_train_step(c["stage"], model, lm, task=c["task"])
    masks = [np.concatenate([m0, m1])
             for m0, m1 in zip(*c["masks"])]
    step(state, to_device(c["batch"], torch.device("cpu")), Feeder(masks),
         priorities=torch.from_numpy(np.concatenate(c["pri"])))
    one = model.state_dict()
    diffs = [float((one[k] - v).abs().max()) for k, v in r0["state"].items()
             if "running" not in k and v.is_floating_point()]
    # not equal: each rank normalises by its own rows' statistics...
    assert max(diffs) > 0
    # ...but an Adam step apart at most
    assert max(diffs) < 2 * LR + 1e-6

    # with the batch statistics out of the picture the forward does not
    # depend on the layout
    model.load_state_dict(c["weights"])
    batch = to_device(c["batch"], torch.device("cpu"))
    with torch.no_grad(), eval_form(model):
        full = model(batch["image"], batch["p2p"])
        halves = [model(batch["image"][i:i + 2], batch["p2p"][i:i + 2])
                  for i in (0, 2)]
    for k in ("depth_preds_metric", "bev_features",
              "inpainting_sam_preds"):
        got = torch.cat([h[k] for h in halves])
        _close(got, full[k], 1e-4, k)


def test_rank_rows_equal_jax_sharded_batch():
    ds_cfg = copy.deepcopy(GROUPS["dataset"]["synthetic_tiny"])
    ds_cfg["val"]["length"] = 5  # a last validation batch of 1 row
    mesh = make_mesh(WORLD)
    for split, kw in (("train", dict(shuffle=True, seed=4)),
                      ("val", dict(shuffle=False, drop_last=False))):
        tf = dict(train=(jaugment, augment_sample)).get(split, (None, None))
        ref = list(JLoader(jbuild_dataset(JConfig(ds_cfg), split), B,
                           transform=tf[0], num_workers=2, **kw).epoch(1))
        ours = [list(EpochLoader(build_dataset(ds_cfg, split), B,
                                 transform=tf[1], num_workers=2, rank=r,
                                 world_size=WORLD, **kw).epoch(1))
                for r in range(WORLD)]
        assert len(ref) == len(ours[0]) == len(ours[1]) > 0
        if split == "val":
            assert len(next(iter(ref[-1].values()))) == 1
        for t, b in enumerate(ref):
            sharded = jshard_batch(_pad_to_multiple(b, WORLD), mesh)
            for k, v in sharded.items():
                if isinstance(v, dict):
                    continue
                shards = sorted(v.addressable_shards,
                                key=lambda s: s.index[0].start or 0)
                for r in range(WORLD):
                    np.testing.assert_array_equal(
                        ours[r][t][k], np.asarray(shards[r].data),
                        err_msg=f"{split} batch {t} rank {r} {k}")


def test_devices_without_a_group_raise():
    cfg = GROUPS["model"]["traversability/tiny"]
    with pytest.raises(ValueError, match="torchrun --nproc_per_node=2"):
        run_training("traversability", cfg, [], None,
                     {"device": "cpu", "devices": 2})


def test_only_rank_zero_writes(tmp_path):
    argv = ["trainer=smoke", "model=traversability/tiny",
            "dataset=synthetic_tiny", "trainer.device=cpu",
            "trainer.devices=2", "trainer.verbose=false",
            "model.batch_size=4", "trainer.num_workers=1",
            "model.vision_backbone.vision_backbone.effnet_cfgs."
            "stage_repeats=1", f"trainer.ckpt_dir={tmp_path}"]
    assert train_traversability.main(argv) is None  # the ranks trained
    with open(tmp_path / "metrics.jsonl") as f:
        rows = [json.loads(ln) for ln in f]
    # one train-epoch and one validation line: the ranks' means, written
    # once; a step line per step
    assert [r.get("split") for r in rows] == [None, "train_epoch", "val"]
    assert rows[0]["step"] == 1 and rows[1]["step"] == 1
    assert sorted(os.listdir(tmp_path)) == ["metrics.jsonl", "step_1"]
    saved = ckpt.load_state_file(str(tmp_path / "step_1"))
    assert saved["step"] == 1
    assert all(np.isfinite(v) for r in rows for v in r.values()
               if isinstance(v, float))
