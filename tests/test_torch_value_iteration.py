"""The port's value iteration (ops/value_iteration.py) against the JAX
package: the XLA ``while_loop`` and the Pallas kernel in interpret mode.

On the CPU ``value_iteration`` runs its plain version; the CUDA kernel is
held to that version on the card (test_torch_cuda.py, chip_smoke.py).
Tolerances: V rtol 1e-3 / atol 5e-3, the bar of tests/test_vi_pallas.py (a
solve that stops one sweep apart differs by up to the 1e-3 threshold); the
policy/Q tail from JAX's own V 1e-5 (one stencil, f32 sums in another
order).
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from creste_public_tpu.ops.value_iteration import bellman_kernels as jkernels
from creste_public_tpu.ops.value_iteration import value_iteration as jvi
from creste_public_tpu.ops.vi_pallas import value_iteration_pallas
from creste_public_tpu_torch.ops import value_iteration as vi
from creste_public_tpu_torch.ops.vi_kernel import value_iteration_cuda

CU = (Path(vi.__file__).resolve().parent.parent / "csrc"
      / "value_iteration.cu")


def _reward(shape=(2, 16, 32, 1), seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * 0.1 - 0.05).astype(np.float32)


def test_bellman_kernels_equal_jax():
    np.testing.assert_array_equal(vi.bellman_kernels(), jkernels())
    assert vi.DYNAMICS.tolist() == [[-1, -1], [-1, 0], [-1, 1], [0, -1],
                                    [0, 1], [1, -1], [1, 0], [1, 1]]


def test_kernel_source_taps_equal_bellman_kernels():
    """The CUDA source's tap tables (ky * 3 + kx per action) rebuild the
    Bellman kernels exactly."""
    src = CU.read_text()
    tables = {n: [int(t) for t in re.search(
        rf"k{n}\[8\] = \{{([^}}]*)\}}", src).group(1).split(",")]
        for n in "LCR"}
    w = np.zeros((3, 3, 1, 8), np.float32)
    for a in range(8):
        for n, wt in zip("LCR", (0.1, 0.8, 0.1)):
            w[tables[n][a] // 3, tables[n][a] % 3, 0, a] += wt
    np.testing.assert_array_equal(w, jkernels())


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_plain_solve_matches_jax(backend):
    r = _reward()
    if backend == "xla":
        ref = np.asarray(jvi(jnp.asarray(r), backend="xla")[0])
    else:
        ref = np.asarray(value_iteration_pallas(jnp.asarray(r),
                                                interpret=True))
    v = vi.value_iteration_plain(torch.from_numpy(r))
    assert v.shape == r.shape and v.dtype == torch.float32
    assert 0 < vi.value_iteration_plain.sweeps < 2000
    np.testing.assert_allclose(v.numpy(), ref, rtol=1e-3, atol=5e-3)


def test_tail_from_jax_value_matches_jax():
    r = _reward(seed=1)
    v, policy, q = (np.array(a) for a in jvi(jnp.asarray(r),
                                               backend="xla"))
    p_t, q_t = vi.policy_and_q(torch.from_numpy(r), torch.from_numpy(v),
                               0.99)
    assert q_t.shape == policy.shape == (2, 16, 32, 8)
    np.testing.assert_allclose(q_t.numpy(), q, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(p_t.numpy(), policy, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(p_t.sum(-1).numpy(), 1.0, atol=1e-6)


def test_value_iteration_dispatches_cpu_to_plain():
    r = torch.from_numpy(_reward(seed=2))
    value_iteration_cuda.launches = 0
    v, policy, q = vi.value_iteration(r, discount=0.95)
    assert value_iteration_cuda.launches == 0
    torch.testing.assert_close(v, vi.value_iteration_plain(r, 0.95),
                               rtol=0, atol=0)
    ref = [np.asarray(a) for a in jvi(jnp.asarray(r.numpy()), discount=0.95,
                                      backend="xla")]
    np.testing.assert_allclose(v.numpy(), ref[0], rtol=1e-3, atol=5e-3)
    np.testing.assert_allclose(policy.numpy(), ref[1], rtol=1e-3, atol=1e-3)
    with pytest.raises(ValueError, match="CUDA"):
        vi.value_iteration(torch.zeros(1, 4, 4, 1, device="meta"))


def test_sweep_cap_and_zero_sweeps():
    r = torch.from_numpy(_reward(seed=3))
    v = vi.value_iteration_plain(r, max_iters=7)
    assert vi.value_iteration_plain.sweeps == 7
    ref = np.asarray(jvi(jnp.asarray(r.numpy()), max_iters=7,
                         backend="xla")[0])
    np.testing.assert_allclose(v.numpy(), ref, rtol=1e-6, atol=1e-6)
    assert not vi.value_iteration_plain(r, max_iters=0).any()
    assert vi.value_iteration_plain.sweeps == 0


def test_goal_attracts_value():
    r = np.full((1, 16, 32, 1), -0.01, np.float32)
    r[0, 8, 16, 0] = 1.0
    v = vi.value_iteration(torch.from_numpy(r))[0][0, :, :, 0].numpy()
    ref = np.asarray(value_iteration_pallas(jnp.asarray(r), interpret=True))
    np.testing.assert_allclose(v, ref[0, :, :, 0], rtol=1e-3, atol=5e-3)
    peak = np.unravel_index(v.argmax(), v.shape)
    assert abs(peak[0] - 8) <= 1 and abs(peak[1] - 16) <= 1
    assert v[8, 16] > v[8, 20] > v[8, 28]
