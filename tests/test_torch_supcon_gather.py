"""SupCon's cross-rank gather against the JAX package's
``multi_pos_con_loss(axis_name="data")`` under ``shard_map``.

Four spawned gloo ranks (``tests/test_torch_dp_ranks.py``) each take their
rows of a global set of features, labels and slot validity (some slots
invalid, labels shared across ranks so that positives cross them, one case
with class weights) and compute the loss with ``group``: each rank's loss
and the gradient of its features (the gather's backward: every rank's
cotangent for those rows, summed) meet the JAX package's per-device loss
and per-device gradient (the transpose of ``lax.all_gather``) to RTOL of
their scale. A control, each rank's rows contrasted with themselves only,
lands above it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from creste_public_tpu.losses.supcon import (
    multi_pos_con_loss as jmulti_pos_con_loss,
)
from creste_public_tpu.parallel import make_mesh
from creste_public_tpu_torch.losses.supcon import multi_pos_con_loss
from tests.test_torch_dp_ranks import run_ranks, supcon_ranks

WORLD = 4
M, Z = 24, 8
RTOL = 1e-5


def _case(seed: int, weighted: bool) -> dict:
    rng = np.random.default_rng(seed)
    c = dict(feats=rng.normal(size=(WORLD * M, Z)).astype(np.float32),
             labels=rng.integers(1, 6, size=(WORLD * M,)).astype(np.int32),
             valid=rng.uniform(size=(WORLD * M,)) > 0.2)
    if weighted:
        c["class_weights"] = rng.uniform(0.5, 2.0, size=(6,)).astype(
            np.float32)
    return c


def _jax(c: dict):
    """Per-device losses [WORLD] and per-device feature gradients."""
    cw = c.get("class_weights")
    cw = None if cw is None else jnp.asarray(cw)

    def per_device(fe, la, va):
        def loss(f):
            return jmulti_pos_con_loss(f, la, va, 0.1, class_weights=cw,
                                       axis_name="data")
        value, grad = jax.value_and_grad(loss)(fe)
        return value[None], grad

    f = jax.jit(jax.shard_map(
        per_device, mesh=make_mesh(WORLD),
        in_specs=(P("data"), P("data"), P("data")),
        out_specs=(P("data"), P("data")), check_vma=False))
    loss, grad = f(jnp.asarray(c["feats"]), jnp.asarray(c["labels"]),
                   jnp.asarray(c["valid"]))
    return np.asarray(loss), np.asarray(grad)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    cases = [_case(0, False), _case(1, True)]
    got = run_ranks(supcon_ranks, WORLD, tmp_path_factory.mktemp("supcon"),
                    cases)
    return cases, got


@pytest.mark.parametrize("i", [0, 1], ids=["plain", "class_weights"])
def test_gathered_loss_and_gradient_match_jax(ranks, i):
    cases, got = ranks
    c = cases[i]
    want_loss, want_grad = _jax(c)
    g_scale = np.abs(want_grad).max()
    assert g_scale > 0
    for r in range(WORLD):
        mine = got[r][i]
        assert mine["loss"] == pytest.approx(float(want_loss[r]), rel=RTOL)
        d = np.abs(mine["grad"] - want_grad[r * M:(r + 1) * M]).max()
        assert d <= RTOL * g_scale, (r, d, g_scale)

    # the control: rank 1's rows against themselves only
    rows = slice(M, 2 * M)
    local = multi_pos_con_loss(
        torch.from_numpy(c["feats"][rows]),
        torch.from_numpy(c["labels"][rows]),
        torch.from_numpy(c["valid"][rows]), 0.1,
        class_weights=(torch.from_numpy(c["class_weights"])
                       if "class_weights" in c else None))
    assert abs(float(local) - float(want_loss[1])) > 100 * RTOL * abs(
        float(want_loss[1]))
