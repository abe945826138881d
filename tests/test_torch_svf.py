"""The port's SVF propagation, sharpening and greedy rollout (ops/svf.py)
against the JAX package: the XLA ``scan`` and the Pallas kernel in
interpret mode.

On the CPU ``expected_svf`` runs its plain version; the CUDA kernel is held
to that version on the card (test_torch_cuda.py, chip_smoke.py).
Tolerances: SVF rtol 1e-5 / atol 1e-6, the bar of tests/test_svf_pallas.py;
sharpen 1e-6; the rollout's integer states exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from creste_public_tpu.ops import svf as jsvf
from creste_public_tpu.ops.svf_pallas import expected_svf_pallas
from creste_public_tpu_torch.ops import svf
from creste_public_tpu_torch.ops.svf_kernel import expected_svf_cuda


def _random_policy(rng, B, H, W):
    logits = rng.normal(size=(B, H, W, 8)).astype(np.float32)
    return np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)


@pytest.mark.parametrize("zts", [False, True])
def test_plain_svf_matches_jax(zts):
    rng = np.random.default_rng(0)
    B, H, W = 3, 16, 32
    policy = _random_policy(rng, B, H, W)
    s0 = rng.integers(0, H * W, size=B)
    s1 = s0.copy() if zts else rng.integers(0, H * W, size=B)
    s1[0] = rng.integers(0, H * W)
    args = (jnp.asarray(policy), jnp.asarray(s0), jnp.asarray(s1))
    ref_xla = np.asarray(jsvf.expected_svf(*args, horizon=12,
                                           zero_terminal_state=zts,
                                           backend="xla"))
    ref_pallas = np.asarray(expected_svf_pallas(*args, horizon=12,
                                                zero_terminal_state=zts,
                                                interpret=True))
    expected_svf_cuda.launches = 0
    got = svf.expected_svf(torch.from_numpy(policy), torch.from_numpy(s0),
                           torch.from_numpy(s1), 12, zts).numpy()
    assert expected_svf_cuda.launches == 0
    assert got.shape == (B, H, W)
    np.testing.assert_allclose(got, ref_xla, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, ref_pallas, rtol=1e-5, atol=1e-6)
    if zts:  # mass is removed at s1 == s0 on the first step
        assert got[1:].sum() < 1e-6
    else:  # at most one unit of mass per step
        assert (got.sum((1, 2)) <= 12 + 1e-4).all()


def test_boundary_mass_falls_off():
    H = W = 8
    a_right = int(np.where((svf.DYNAMICS == [0, 1]).all(1))[0][0])
    policy = np.zeros((1, H, W, 8), np.float32)
    policy[..., a_right] = 1.0
    s0 = np.array([3 * W + (W - 2)])
    ref = np.asarray(jsvf.expected_svf(jnp.asarray(policy), jnp.asarray(s0),
                                       jnp.asarray(s0), horizon=5,
                                       backend="xla"))
    got = svf.expected_svf(torch.from_numpy(policy), torch.from_numpy(s0),
                           torch.from_numpy(s0), 5).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)
    # visits (3, 6) and (3, 7) once each, then the mass leaves the grid
    assert np.isclose(got.sum(), 2.0, atol=1e-6)
    assert got[0, 3, 6] == got[0, 3, 7] == 1.0


def test_horizon_one_is_the_start_state():
    policy = torch.full((2, 4, 5, 8), 1 / 8)
    s0 = torch.tensor([0, 7])
    got = svf.expected_svf(policy, s0, s0, 1)
    assert got.sum() == 2 and got[1, 1, 2] == 1


def test_sharpen_policy_matches_jax():
    rng = np.random.default_rng(1)
    policy = _random_policy(rng, 2, 8, 16)
    for temp in (0.005, 0.5):
        ref = np.asarray(jsvf.sharpen_policy(jnp.asarray(policy), temp))
        got = svf.sharpen_policy(torch.from_numpy(policy), temp).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_greedy_rollout_matches_jax():
    rng = np.random.default_rng(2)
    B, H, W, T = 3, 16, 32, 20
    policy = _random_policy(rng, B, H, W)
    # a tie between actions 2 and 5 everywhere in element 0: both take
    # the first maximal action
    policy[0, ..., 2] = policy[0, ..., 5] = 2.0
    s0 = rng.integers(0, H * W, size=B)
    states, grid = jsvf.greedy_rollout(jnp.asarray(policy), jnp.asarray(s0),
                                       T)
    got_s, got_g = svf.greedy_rollout(torch.from_numpy(policy),
                                      torch.from_numpy(s0), T)
    assert got_s.shape == (B, T, 2) and got_g.shape == (B, H, W)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(states))
    np.testing.assert_array_equal(got_g.numpy(), np.asarray(grid))
    assert (got_g.sum((1, 2)) == T).all()


def test_cuda_wrapper_refuses_cpu_tensors():
    p = torch.full((1, 4, 4, 8), 1 / 8)
    s = torch.zeros(1, dtype=torch.long)
    with pytest.raises(ValueError, match="CUDA"):
        expected_svf_cuda(p, s, s, 3)
    with pytest.raises(ValueError, match="CUDA"):
        svf.expected_svf(p.to("meta"), s.to("meta"), s.to("meta"), 3)
