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


def _schedule():
    """(k, tile rows, tile columns) compiled into value_iteration.cu."""
    src = CU.read_text()
    return tuple(int(re.search(rf"constexpr int {n} = (\d+);", src).group(1))
                 for n in ("kSweepsPerBarrier", "kTileH", "kTileW"))


def _blocked_solve(r, discount, threshold, max_iters, k, th, tw):
    """numpy emulation of the CUDA kernel's schedule: per phase of k sweeps,
    every th x tw tile is loaded with a halo of k cells, swept k times over
    a region that shrinks by one ring per sweep, and its interior's change
    and values are recorded per sweep; the stop is decided after the phase.
    f32 with separate roundings, as the kernel. Returns (V, sweeps,
    barriers)."""
    f32 = np.float32
    B, H, W = r.shape
    g, limit = f32(discount), f32(threshold)
    LH, LW = th + 2 * k, tw + 2 * k
    taps = [[(ky * 3 + kx, f32(w)) for ky, kx, w in t]
            for t in vi.ACTION_TAPS]
    v_in = np.zeros_like(r)
    it, stop, barriers = 0, (0 if max_iters == 0 else None), 0
    while stop is None:
        ks = min(k, max_iters - it)
        deltas = np.zeros(ks, f32)
        outs = [np.full_like(r, np.nan) for _ in range(ks)]
        for b in range(B):
            for Y0 in range(-k, H - k, th):
                for X0 in range(-k, W - k, tw):
                    ys, xs = np.arange(Y0, Y0 + LH), np.arange(X0, X0 + LW)
                    inmap = ((ys >= 0) & (ys < H))[:, None] & (
                        (xs >= 0) & (xs < W))[None, :]
                    yc, xc = np.clip(ys, 0, H - 1), np.clip(xs, 0, W - 1)
                    sr = np.where(inmap, r[b][np.ix_(yc, xc)], f32(0))
                    sv = np.where(inmap, v_in[b][np.ix_(yc, xc)], f32(0))
                    sp = np.full((LH, LW), np.nan, f32)
                    for s in range(ks):
                        reg = (slice(s, LH - s), slice(s, LW - s))
                        sp[reg] = np.where(inmap[reg],
                                           sr[reg] + g * sv[reg], f32(0))
                        hh, ww = LH - 2 * (s + 1), LW - 2 * (s + 1)
                        nb = [sp[s + ky:s + ky + hh, s + kx:s + kx + ww]
                              for ky in range(3) for kx in range(3)]
                        best = None
                        for t in taps:
                            q = ((t[0][1] * nb[t[0][0]]
                                  + t[1][1] * nb[t[1][0]])
                                 + t[2][1] * nb[t[2][0]])
                            best = q if best is None else np.maximum(best, q)
                        old = sv[s + 1:LH - s - 1, s + 1:LW - s - 1]
                        i0 = k - (s + 1)  # the interior inside this region
                        ih = min(th, H - (Y0 + k))
                        iw = min(tw, W - (X0 + k))
                        new_i = best[i0:i0 + ih, i0:i0 + iw]
                        d = np.abs(new_i - old[i0:i0 + ih, i0:i0 + iw]).max()
                        deltas[s] = np.maximum(deltas[s], d)
                        outs[s][b, Y0 + k:Y0 + k + ih,
                                X0 + k:X0 + k + iw] = new_i
                        sv[s + 1:LH - s - 1, s + 1:LW - s - 1] = best
        barriers += 1
        for s in range(ks):
            if not deltas[s] > limit:
                stop = it + s + 1
                break
        if stop is None:
            it += ks
            v_in = outs[-1]
            if it >= max_iters:
                stop = it
    if stop == 0:
        return np.zeros_like(r), 0, barriers
    return outs[stop - 1 - it], stop, barriers


def _signed_goal_reward(shape, seed):
    r = np.random.default_rng(seed).uniform(size=shape).astype(np.float32)
    r -= np.float32(0.6)
    r[:, shape[1] // 2, shape[2] // 2] = 1.0
    return r


@pytest.mark.parametrize("case", ["stop_in_block", "signed_goal",
                                  "ragged", "cap_not_multiple", "cap_zero"])
def test_blocked_schedule_equals_plain_to_the_bit(case):
    """The kernel's temporal blocking (k sweeps per grid barrier, tiles with
    a k-cell halo, read from value_iteration.cu) gives V bit for bit and
    the same sweep count as value_iteration_plain, with ceil(sweeps / k)
    barriers."""
    k, th, tw = _schedule()
    assert 1 <= k <= 32 and th >= 1 and tw >= 1
    discount, max_iters = 0.9, 2000
    if case == "stop_in_block":
        r = _reward((2, th, 2 * tw, 1), seed=4)[..., 0]
    elif case == "signed_goal":
        r = _signed_goal_reward((2, th + 3, tw + 5), seed=5)
    elif case == "ragged":  # maps not a multiple of the tile
        r = _reward((2, 2 * th + 5, tw + 7, 1), seed=6)[..., 0]
    elif case == "cap_not_multiple":
        r, max_iters = _signed_goal_reward((1, th + 1, tw - 3), 7), 2 * k + 3
    else:
        r, max_iters = _reward((1, 9, 13, 1), seed=8)[..., 0], 0
    v, sweeps, barriers = _blocked_solve(r, discount, 1e-3, max_iters, k,
                                         th, tw)
    ref = vi.value_iteration_plain(torch.from_numpy(r)[..., None], discount,
                                   1e-3, max_iters)
    assert sweeps == vi.value_iteration_plain.sweeps
    np.testing.assert_array_equal(v, ref[..., 0].numpy())
    assert barriers == -(-sweeps // k)
    if case == "stop_in_block":
        assert 0 < sweeps < max_iters and sweeps % k != 0
    if case.startswith("cap"):
        assert sweeps == max_iters


def test_goal_attracts_value():
    r = np.full((1, 16, 32, 1), -0.01, np.float32)
    r[0, 8, 16, 0] = 1.0
    v = vi.value_iteration(torch.from_numpy(r))[0][0, :, :, 0].numpy()
    ref = np.asarray(value_iteration_pallas(jnp.asarray(r), interpret=True))
    np.testing.assert_allclose(v, ref[0, :, :, 0], rtol=1e-3, atol=5e-3)
    peak = np.unravel_index(v.argmax(), v.shape)
    assert abs(peak[0] - 8) <= 1 and abs(peak[1] - 16) <= 1
    assert v[8, 16] > v[8, 20] > v[8, 28]
