"""Multi-task datasets through the port's loader and training command,
against the JAX package's.

``test_multitask_iterator_bit_equal``: ``MultiTaskIterator`` over the
``synthetic_tiny_multitask`` tasks (``joint`` 2 batches, ``depth`` 1, so
the depth loader is exhausted and restarted on epoch ``epoch + 1000 +
count`` within every epoch) yields the JAX iterator's ``(task, batch)``
sequence bit for bit over two epochs, augmented, in thread and in process
mode, and on each rank of two its rows of the JAX batch.

``test_cli_tasks_and_augmentation_match_the_jax_cli``: ``train_ssc`` with
``dataset=synthetic_tiny_multitask dataset.do_augmentation=true`` and the
JAX package's CLI with the same arguments (the trunk cut to one block per
stage, as tests/test_torch_ssc_cli.py cuts it): the same seeded weights on
both sides, the JAX step's SupCon priorities the port's first step's. The
metrics lines carry the same keys (a ``joint`` step, a ``depth`` step, the
epoch and the validation on the first task's split), those of
``chip_smoke.MULTITASK_KEYS`` for the card's run; the first step's
losses meet JAX's to METRIC_RTOL (one forward from the same weights and
batch); the second step's losses to GRAD_NORM_RTOL of
tests/test_torch_ssc_cli.py (each side after its own Adam step, whose
first update is about lr times the sign of each gradient entry, so the
states differ where the two gradients' signs do). ``grad_norm`` is not
compared: with these unjittered weights it is ~3e3, carried by entries
that cross this preset's f32-flipped ReLU kinks (it read 1.5% and 2.8%
from JAX's in two runs); tests/test_torch_ssc_cli.py compares it where it
is well conditioned.
"""
import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from creste_public_tpu.config.config import Config as JConfig
from creste_public_tpu.config.config import compose_cli as jcompose_cli
from creste_public_tpu.data.augment import augment_sample as jaugment
from creste_public_tpu.data.dataloader import EpochLoader as JLoader
from creste_public_tpu.data.dataloader import MultiTaskIterator as JMulti
from creste_public_tpu.data.dataloader import build_dataset as jbuild_dataset
from creste_public_tpu.models.terrainnet import TerrainNet as JTerrainNet
from creste_public_tpu_torch import train_ssc, weights
from creste_public_tpu_torch.config.groups import GROUPS
from creste_public_tpu_torch.data.augment import augment_sample
from creste_public_tpu_torch.data.dataloader import (
    EpochLoader,
    MultiTaskIterator,
    build_dataset,
)
from creste_public_tpu_torch.parallel import pad_to_multiple, shard_batch
from creste_public_tpu_torch.training.loop import step_generator
from creste_public_tpu_torch.weights import from_jax_variables
from tests.test_torch_helpers import jax_variables, seeded_variables
from tests.test_torch_step_helpers import one_torch_thread  # noqa: F401

CONFIG_DIR = os.path.join(os.path.dirname(__file__), "..", "configs")
TASKS = GROUPS["dataset"]["synthetic_tiny_multitask"]["tasks"]
METRIC_RTOL = 1e-4
GRAD_NORM_RTOL = 2e-2


def _iterators(mode: str = "thread", rank: int = 0, world: int = 1):
    kw = dict(shuffle=True, seed=0, num_workers=2)
    ours = MultiTaskIterator({
        name: EpochLoader(build_dataset(sub, "train"), 2,
                          transform=augment_sample, worker_mode=mode,
                          rank=rank, world_size=world, **kw)
        for name, sub in TASKS.items()})
    ref = JMulti({
        name: JLoader(jbuild_dataset(JConfig(sub), "train"), 2,
                      transform=jaugment, **kw)
        for name, sub in TASKS.items()})
    return ours, ref


@pytest.mark.parametrize("mode, world", [("thread", 1), ("process", 1),
                                         ("thread", 2)])
def test_multitask_iterator_bit_equal(mode, world):
    for rank in range(world):
        ours, ref = _iterators(mode, rank, world)
        try:
            for epoch in (0, 1):
                got = list(ours.epoch(epoch))
                want = list(ref.epoch(epoch))
                assert [t for t, _ in got] == [t for t, _ in want] == [
                    "joint", "depth", "joint", "depth"]
                # the depth loader restarted mid-epoch: its second batch is
                # the restart's, not a repeat of the first
                assert not np.array_equal(got[1][1]["image"],
                                          got[3][1]["image"])
                for (_, b), (_, r) in zip(got, want):
                    r = shard_batch(pad_to_multiple(r, world), rank, world)
                    assert b.keys() == r.keys()
                    for k in b:
                        np.testing.assert_equal(b[k], r[k], err_msg=k)
        finally:
            for ld in ours.loaders.values():
                ld.close()


def _rows(d):
    with open(os.path.join(d, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_cli_tasks_and_augmentation_match_the_jax_cli(tmp_path, monkeypatch):
    from creste_public_tpu.cli import train_from_config as jtrain

    argv = ["trainer=smoke", "model=ssc_sam/tiny",
            "dataset=synthetic_tiny_multitask", "dataset.do_augmentation=true",
            "trainer.verbose=false", "trainer.devices=1",
            "model.vision_backbone.effnet_cfgs.stage_repeats=1"]
    cfg = copy.deepcopy(GROUPS["model"]["ssc_sam/tiny"])
    cfg["vision_backbone"]["effnet_cfgs"]["stage_repeats"] = 1
    image = np.zeros((1, 1, 64, 80, 4), np.float32)
    p2p = np.tile(np.eye(4, dtype=np.float32), (1, 1, 1, 1))
    flat = seeded_variables(JTerrainNet(cfg), image, p2p)

    init = JTerrainNet.init

    def seeded_init(self, rngs, *args, **kwargs):
        return jax_variables(seeded_variables(
            self, *args, init=lambda r, *a: init(self, r, *a, **kwargs)))

    # the port's first step's priorities: its generator draws no mask at
    # this trunk, so they are the generator's first draw
    n = 2 * 32 * 32
    pri = torch.rand(n, generator=step_generator(0, 0)).numpy()
    real_uniform = jax.random.uniform

    def uniform(key, shape=(), *a, **k):
        if tuple(shape) == (n,):
            return jnp.asarray(pri)
        return real_uniform(key, shape, *a, **k)

    monkeypatch.setattr(JTerrainNet, "init", seeded_init)
    monkeypatch.setattr(jax.random, "uniform", uniform)
    monkeypatch.setattr(weights, "init_weights", lambda model, seed: (
        model.load_state_dict(from_jax_variables(flat), strict=True),
        model)[1])
    state = train_ssc.main(argv + [f"trainer.ckpt_dir={tmp_path / 'port'}",
                                   "trainer.device=cpu"])
    jtrain(jcompose_cli("ssc_sam", CONFIG_DIR,
                        argv + [f"trainer.ckpt_dir={tmp_path / 'jax'}"]))
    ours, ref = _rows(tmp_path / "port"), _rows(tmp_path / "jax")
    assert [sorted(r) for r in ours] == [sorted(r) for r in ref]
    assert [r.get("split") for r in ours] == [None, None, "train_epoch", "val"]
    # chip_smoke.py phase 31 holds the card's run to these keys
    import chip_smoke

    assert set(ref[0]) == chip_smoke.MULTITASK_KEYS["joint"]
    assert set(ref[1]) == chip_smoke.MULTITASK_KEYS["depth"]
    joint, depth = ours[0], ours[1]
    assert "SupPixelConLoss/joint/3d_sam_label/supcon/sem_loss" in joint
    assert not any("supcon" in k or "joint" in k for k in depth)
    assert "CrossEntropyDepth/depth/cls_loss" in depth
    assert all(np.isfinite(v) for r in ours for v in r.values()
               if isinstance(v, float))
    for t, rtol in ((0, METRIC_RTOL), (1, GRAD_NORM_RTOL)):
        for k, v in ref[t].items():
            if k in ("wall_s", "step", "epoch", "grad_norm"):
                continue
            np.testing.assert_allclose(ours[t][k], v, rtol=rtol, atol=1e-6,
                                       err_msg=f"step {t + 1} {k}")
    assert state.step == 2
