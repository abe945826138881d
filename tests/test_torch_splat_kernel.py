"""The splat's operator ``creste::splat_sums`` (``ops/splat_kernel.py``) on
the CPU, against the plain version beside it (``ops/splat.py``) and the JAX
package.

Exactness: on the CPU the operator is the plain version, so its outputs
and its gradients (``register_autograd``: the plain version's backward op
for op) are held to the bit, in every splat mode. The kernel of
``csrc/splat.cu`` rests on one premise, held here too: the CPU's
``index_add_`` adds a voxel's votes in ordinal order, so an explicit f32
loop over the votes in that order gives the plain version's bits. The
gradients against ``jax.grad`` of the JAX package's ``splat_bilinear`` are
held to 1e-5 of max(1, max|ref|) (f32 sums in another order). The kernel
itself runs on the card only (``tests/test_torch_cuda.py``, marked
``gpu``); here its wrapper must refuse CPU tensors.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from creste_public_tpu.config import presets as jpresets
from creste_public_tpu.ops import splat as js
from creste_public_tpu_torch import weights
from creste_public_tpu_torch.models.lfd import MaxEntIRL
from creste_public_tpu_torch.ops import _build
from creste_public_tpu_torch.ops import splat as ts
from creste_public_tpu_torch.ops import splat_kernel as sk
from creste_public_tpu_torch.runtime.compile import example_inputs
from creste_public_tpu_torch.runtime.export import (
    build_inference_fn,
    export_inference_graph,
)

GRAD_RTOL = 1e-5


def _points(seed, B=2, P=300, F=5, H=12, W=10, lo=-1.5, pad=0.5):
    """xy over the grid and past every edge, features normal."""
    rng = np.random.default_rng(seed)
    xy = np.stack([rng.uniform(lo, W + pad, (B, P)),
                   rng.uniform(lo, H + pad, (B, P))], -1).astype(np.float32)
    return xy, rng.normal(size=(B, P, F)).astype(np.float32), (H, W)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


def _plain_max(xy, feats, grid):
    """The 'max' splat as the port computed it before the operator: its
    densities by a 1-D ``index_add_`` of the weights."""
    H, W = grid
    B, P, F = feats.shape
    flat, w4 = ts._corners(xy, grid)
    upd = w4[..., None] * feats.float().repeat(1, 4, 1)
    dens = torch.zeros(B * H * W).index_add_(0, flat, w4.reshape(-1))
    feat = torch.zeros(B * H * W, F).scatter_reduce_(
        0, flat[:, None].expand(-1, F), upd.reshape(-1, F), reduce="amax",
        include_self=True)
    return feat.reshape(B, H * W, F), dens.reshape(B, H * W)


@pytest.mark.parametrize("mode", ["mean", "sum", "max"])
@pytest.mark.parametrize("seed", [0, 1])
def test_operator_equals_plain_to_the_bit(mode, seed):
    """``splat_bilinear`` through the operator equals the plain version's
    splat bit for bit: sums and densities (mean, sum) and the max splat's
    maxima and densities."""
    xy, feats, grid = _points(seed)
    xy_t, f_t = torch.from_numpy(xy), torch.from_numpy(feats)
    got_f, got_d = ts.splat_bilinear(xy_t, f_t, grid, mode)
    if mode == "max":
        want_f, want_d = _plain_max(xy_t, f_t, grid)
    else:
        want_f, want_d = ts.finish_splat(
            ts.splat_sums_plain(xy_t, f_t, grid), mode, 1.0, f_t.dtype)
    assert torch.equal(_bits(got_f), _bits(want_f))
    assert torch.equal(_bits(got_d), _bits(want_d))


def test_operator_keeps_non_finite_features():
    """An inf or NaN feature gives what the plain version gives: NaN in
    voxel 0 where the point's corner is off the grid (0 * inf), the
    non-finite sum where it lands."""
    xy, feats, grid = _points(2, B=1, P=64, F=3, H=4, W=4)
    xy[0, :4] = [[-3.0, 1.5], [1.25, 2.5], [np.inf, 0.5], [2.0, 2.0]]
    feats[0, 0, 0], feats[0, 1, 1] = np.inf, np.nan
    feats[0, 2, 2], feats[0, 3, 0] = -np.inf, np.inf
    xy_t, f_t = torch.from_numpy(xy), torch.from_numpy(feats)
    got = torch.ops.creste.splat_sums(xy_t, f_t, *grid)
    want = ts.splat_sums_plain(xy_t, f_t, grid)
    assert bool(got[0, 0, 0].isnan()) and bool(got[0, 0, 2].isnan())
    same = (_bits(got) == _bits(want)) | (got.isnan() & want.isnan())
    assert bool(same.all())


@pytest.mark.parametrize("F", [0, 7])
def test_plain_sums_follow_the_ordinal_order(F):
    """The premise of the kernel: the CPU's ``index_add_`` adds each
    voxel's votes in their ordinal order (corner-major, ``votes``' flat
    index), so an explicit f32 loop in that order, from +0, gives the plain
    version's bits, at hundreds of votes per voxel."""
    xy, feats, grid = _points(3, B=2, P=2000, F=F, H=4, W=5)
    xy_t, f_t = torch.from_numpy(xy), torch.from_numpy(feats)
    flat, upd = ts.votes(xy_t, f_t, grid)
    flat, upd = flat.numpy(), upd.reshape(flat.shape[0], F + 1).numpy()
    acc = np.zeros((2 * grid[0] * grid[1], F + 1), np.float32)
    for i in range(flat.shape[0]):
        acc[flat[i]] = acc[flat[i]] + upd[i]
    assert np.bincount(flat).max() > 300
    want = ts.splat_sums_plain(xy_t, f_t, grid).reshape(acc.shape).numpy()
    np.testing.assert_array_equal(acc.view(np.int32), want.view(np.int32))


def _grads(fn, xy, feats, grid, mode, cot):
    xy_t = torch.from_numpy(xy).requires_grad_()
    f_t = torch.from_numpy(feats).requires_grad_()
    f, d = fn(xy_t, f_t, grid, mode)
    loss = (f * torch.from_numpy(cot[0])).sum() + (
        d * torch.from_numpy(cot[1])).sum()
    return torch.autograd.grad(loss, (xy_t, f_t))


def _plain_bilinear(xy, feats, grid, mode):
    return ts.finish_splat(ts.splat_sums_plain(xy, feats, grid), mode, 1.0,
                           feats.dtype)


@pytest.mark.parametrize("mode", ["mean", "sum"])
def test_gradients_equal_plain_and_jax(mode):
    """The operator's gradients with respect to xy and feats equal autograd
    of the plain version bit for bit, and ``jax.grad`` of the JAX package's
    ``splat_bilinear`` within GRAD_RTOL of max(1, max|ref|)."""
    xy, feats, grid = _points(4)
    rng = np.random.default_rng(5)
    B, P, F = feats.shape
    n = grid[0] * grid[1]
    cot = (rng.normal(size=(B, n, F)).astype(np.float32),
           rng.normal(size=(B, n)).astype(np.float32))
    got = _grads(ts.splat_bilinear, xy, feats, grid, mode, cot)
    plain = _grads(_plain_bilinear, xy, feats, grid, mode, cot)
    for g, p in zip(got, plain):
        assert torch.equal(_bits(g), _bits(p))

    def jloss(xy_, f_):
        f, d = js.splat_bilinear(xy_, f_, grid, mode)
        return jnp.sum(f * cot[0]) + jnp.sum(d * cot[1])

    ref = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(xy),
                                          jnp.asarray(feats))
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert float(np.abs(r).max()) > 0
        err = float(np.abs(g.numpy() - r).max())
        assert err <= GRAD_RTOL * max(1.0, float(np.abs(r).max())), err


def test_max_densities_gradient_equals_plain():
    """The max splat's density gradient through the operator (F = 0)
    equals autograd of the plain 1-D ``index_add_`` (a sum of zeros may
    drop a zero's sign, so equal, not bit-equal)."""
    xy, feats, grid = _points(6)
    cot = np.random.default_rng(7).normal(
        size=(2, grid[0] * grid[1])).astype(np.float32)

    def dens_grad(fn):
        xy_t = torch.from_numpy(xy).requires_grad_()
        d = fn(xy_t, torch.from_numpy(feats), grid)[1]
        return torch.autograd.grad((d * torch.from_numpy(cot)).sum(), xy_t)[0]

    got = dens_grad(ts.splat_max)
    assert torch.equal(got, dens_grad(_plain_max))
    assert float(got.abs().max()) > 0


def test_fake_and_opcheck():
    """Under fake tensors the operator gives [B, H*W, F+1] f32; ``opcheck``
    passes (schema, fake, autograd registration)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    xy, feats, grid = _points(8, B=1, P=40, F=3)
    assert str(torch.ops.creste.splat_sums.default._schema) == (
        "creste::splat_sums(Tensor xy, Tensor feats, int H, int W) -> Tensor")
    with FakeTensorMode() as mode:
        out = torch.ops.creste.splat_sums(
            mode.from_tensor(torch.from_numpy(xy)),
            mode.from_tensor(torch.from_numpy(feats)), *grid)
    assert tuple(out.shape) == (1, grid[0] * grid[1], 4)
    assert out.dtype == torch.float32
    torch.library.opcheck(torch.ops.creste.splat_sums.default,
                          (torch.from_numpy(xy), torch.from_numpy(feats),
                           *grid))


def test_wrapper_refuses_what_the_kernel_does_not_take():
    """``splat_sums_cuda`` launches or raises: a CPU tensor, another dtype,
    a bad shape and sizes past the kernel's int32 indices are refused
    before the library is loaded."""
    xy, feats = torch.zeros(1, 4, 2), torch.zeros(1, 4, 3)
    with pytest.raises(ValueError, match="CUDA"):
        sk.splat_sums_cuda(xy, feats, (8, 8))
    with pytest.raises(ValueError, match="too large"):
        sk.check_sizes(1, 2**29, 4, 8, 8)
    with pytest.raises(ValueError, match=">= 1"):
        sk.check_sizes(1, 4, 4, 0, 8)
    sk.check_sizes(1, 19584, 96, 256, 256)


def test_kernel_source_is_built_and_linked_into_the_host():
    """``csrc/splat.cu`` is a kernel source (phase 1 builds it), and the
    host's op library compiles ``csrc/splat_op.cpp`` beside the head's
    registration and, for the card, ``splat.cu`` beside ``msfcn_chain.cu``.
    """
    from pathlib import Path

    assert "splat" in _build.sources()
    compile_, link = _build.host_commands(False, Path("W"), "op.so", "host")
    srcs = [c[c.index("-c") + 1] for c in compile_]
    assert [Path(s).name for s in srcs] == [
        "msfcn_head_op.cpp", "splat_op.cpp", "serve_host.cpp"]
    assert "W/splat_op.o" in link[0]


def test_exported_graph_holds_one_splat_op(tmp_path):
    """``torch.export`` of the tiny deployment graph holds
    ``creste::splat_sums`` once (one splat), and the reloaded program's
    outputs equal the eager graph's bit for bit."""
    cfg = dict(jpresets.tiny_traversability_config().to_dict(),
               solve_mdp=False)
    rgbd, p2p = example_inputs(64, 80, depth_mm=3000.0)
    model = weights.init_weights(MaxEntIRL(cfg), 0)
    fn = build_inference_fn(cfg, model.state_dict(), "cpu")
    eager = fn(rgbd, p2p)
    program = export_inference_graph(fn.graph, rgbd, p2p,
                                     str(tmp_path / "g.pt2"))
    calls = [n for n in program.graph.nodes
             if n.op == "call_function" and "splat_sums" in str(n.target)]
    assert len(calls) == 1
    with torch.no_grad():
        got = program.module()(torch.from_numpy(rgbd),
                               torch.from_numpy(p2p))
    assert float(eager["bev_densities"].max()) > 0
    for k in eager:
        assert torch.equal(got[k], eager[k]), k
