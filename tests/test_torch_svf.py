"""The port's SVF propagation, sharpening and greedy rollout (ops/svf.py)
against the JAX package: the XLA ``scan`` and the Pallas kernel in
interpret mode.

On the CPU ``expected_svf`` runs its plain version; the CUDA kernel is held
to that version on the card (test_torch_cuda.py, chip_smoke.py), and its
schedule (bands over a cluster, halo rows, double-buffered exchange) is
emulated here and held to the plain version to the bit.
Tolerances: SVF rtol 1e-5 / atol 1e-6, the bar of tests/test_svf_pallas.py;
sharpen 1e-6; the rollout's integer states exactly.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from creste_public_tpu.ops import svf as jsvf
from creste_public_tpu.ops.svf_pallas import expected_svf_pallas
from creste_public_tpu_torch.ops import svf, svf_kernel
from creste_public_tpu_torch.ops.svf_kernel import expected_svf_cuda

CU = Path(svf.__file__).resolve().parent.parent / "csrc" / "svf.cu"


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


def _kernel_constants():
    src = CU.read_text()
    return {n: int(re.search(rf"constexpr int {n} = (\d+);", src).group(1))
            for n in ("kClusterBlocks", "kThreads", "kCellsPerThread")}


def test_wrapper_limits_equal_kernel_source():
    """The wrapper's cluster size and band limit are csrc/svf.cu's, the
    source's action tables are DYNAMICS, and every band of the rule is
    non-empty and fits the cluster."""
    k = _kernel_constants()
    assert svf_kernel.CLUSTER_BLOCKS == k["kClusterBlocks"] <= 8
    assert svf_kernel.MAX_BAND_CELLS == k["kThreads"] * k["kCellsPerThread"]
    src = CU.read_text()
    dy, dx = ([int(t) for t in re.search(rf"k{n}\[8\] = \{{([^}}]*)\}}",
                                         src).group(1).split(",")]
              for n in ("Dy", "Dx"))
    assert [list(p) for p in zip(dy, dx)] == svf.DYNAMICS.tolist()
    for H in range(1, 300):
        C, R = svf_kernel.cluster_shape(H)
        assert C <= k["kClusterBlocks"] and R == -(-H // k["kClusterBlocks"])
        assert (C - 1) * R < H <= C * R
    assert svf_kernel.cluster_shape(64) == (8, 8)


def _cluster_svf(policy, s0, s1, horizon, zts):
    """torch emulation of csrc/svf.cu's schedule, f32 with the kernel's
    separate roundings. Element b's map is split in C bands of R rows
    (``cluster_shape``), one block each. A block keeps per cell the 8
    policy values that flow into it (0 from outside the map), mu and the
    total; per step it writes mu to its exchange buffer of parity
    step % 2 (R + 2 rows of W + 2: a halo row above and below, a zero
    border column each side), its first row into the halo row below of the
    band above and its last row into the halo row above of the band below,
    then gathers each cell's 8 sources from the buffer. Before the writes,
    every slot but the halo rows at the map's top and bottom and the border
    columns (zeroed once) is poisoned with NaN, so a source read from a
    slot that step's writes missed shows in the result.
    Returns (mu [B, H, W], C)."""
    B, H, W, _ = policy.shape
    C, R = svf_kernel.cluster_shape(H)
    Hp = C * R
    rows = [min(R, H - r * R) for r in range(C)]
    valid = (torch.arange(Hp) < H)[:, None].expand(Hp, W)
    padded = torch.nn.functional.pad(policy, (0, 0, 1, 1, 1, Hp - H + 1))
    pin = torch.stack([padded[:, 1 - dy:1 - dy + Hp, 1 - dx:1 - dx + W, a]
                       for a, (dy, dx) in enumerate(svf.DYNAMICS.tolist())],
                      -1)
    pin = torch.where(valid[..., None], pin, 0.0).reshape(B, C, R, W, 8)
    idx = torch.arange(Hp * W).reshape(1, C, R, W)
    valid = valid.reshape(1, C, R, W)
    mu = (valid & (idx == s0.reshape(B, 1, 1, 1))).float()
    kill = valid & (idx == s1.reshape(B, 1, 1, 1)) & zts
    total = torch.zeros_like(mu)
    buf = torch.zeros(B, C, 2, R + 2, W + 2)
    for step in range(horizon - 1):
        cur = buf[:, :, step % 2]
        for r in range(C):  # all but the map's edges and border columns
            top, bottom = int(r == 0), rows[r] + int(r < C - 1)
            cur[:, r, top:bottom + 1, 1:W + 1] = float("nan")
        mu = torch.where(kill, 0.0, mu)
        total = total + mu
        for r in range(C):
            cur[:, r, 1:rows[r] + 1, 1:W + 1] = mu[:, r, :rows[r]]
            if r * R > 0:  # the first row, into the band above
                cur[:, r - 1, R + 1, 1:W + 1] = mu[:, r, 0]
            if r * R + rows[r] < H:  # the last row, into the band below
                cur[:, r + 1, 0, 1:W + 1] = mu[:, r, rows[r] - 1]
        acc = torch.zeros_like(mu)
        for a, (dy, dx) in enumerate(svf.DYNAMICS.tolist()):
            acc = acc + pin[..., a] * cur[:, :, 1 - dy:1 - dy + R,
                                          1 - dx:1 - dx + W]
        mu = torch.where(valid, acc, 0.0)
    return (total + mu).reshape(B, Hp, W)[:, :H], C


@pytest.mark.parametrize("shape,horizon", [
    ((10, 64, 128), 50),  # the stage-3 objective: 8 bands of 8 x 128
    ((3, 37, 53), 50),    # H not a multiple of the cluster: a short band
    ((2, 5, 40), 20),     # H < 8: five bands of one row
    ((2, 16, 1024), 12),  # a band of 2048 cells, 2 per thread
])
@pytest.mark.parametrize("zts", [False, True])
def test_cluster_schedule_equals_plain_to_the_bit(shape, horizon, zts):
    """The kernel's schedule (csrc/svf.cu: bands over a cluster, policy
    read once, halo rows into the neighbours' buffers, double buffering)
    gives the plain version's mu bit for bit."""
    rng = np.random.default_rng(sum(shape) + horizon)
    B, H, W = shape
    policy = torch.from_numpy(_random_policy(rng, B, H, W) ** 3)
    policy = policy / policy.sum(-1, keepdim=True)
    s0 = torch.from_numpy(rng.integers(0, H * W, size=B))
    s1 = torch.from_numpy(rng.integers(0, H * W, size=B))
    s0[0] = s1[0]  # the start is the terminal state
    s0[-1] = (H // 2) * W + W // 2  # near a band edge
    got, C = _cluster_svf(policy, s0, s1, horizon, zts)
    ref = svf.expected_svf_plain(policy, s0, s1, horizon, zts)
    assert C == svf_kernel.cluster_shape(H)[0]
    assert C == min(H, svf_kernel.CLUSTER_BLOCKS) or H % C
    np.testing.assert_array_equal(got.numpy(), ref.numpy())
    assert ref.isfinite().all() and ref.sum() > 0
    if zts:
        assert got[0].sum() == 0  # its mass is removed at the first step


@pytest.mark.parametrize("zts", [False, True])
def test_cluster_schedule_matches_pallas(zts):
    rng = np.random.default_rng(3)
    B, H, W = 3, 16, 32
    policy = _random_policy(rng, B, H, W)
    s0 = rng.integers(0, H * W, size=B)
    s1 = rng.integers(0, H * W, size=B)
    ref = np.asarray(expected_svf_pallas(
        jnp.asarray(policy), jnp.asarray(s0), jnp.asarray(s1), horizon=12,
        zero_terminal_state=zts, interpret=True))
    got, C = _cluster_svf(torch.from_numpy(policy), torch.from_numpy(s0),
                          torch.from_numpy(s1), 12, zts)
    assert C == 8
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)
