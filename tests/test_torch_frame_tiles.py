"""The tile plan of the card's ``assemble_rgbd`` (``ops/frame_kernel.py``
``tile_plan``, ``csrc/frame_io.cu``), on the CPU: what can be held here
without a card.

- every output's Pillow window lies inside its tile's input extent, the
  extents are monotone, the chroma halo that libjpeg's fancy upsampling
  reads lies inside the staged chroma and inside the planes, and each
  tile's parts fit the shared-memory layout under the budget: at the
  frame tests' sizes, at 1024x1224 -> 512x612 and -> 64x80, and per axis
  at every (input, output) length pair up to 40, at 4:4:4, 4:2:2, 4:2:0;
- a walk of the plan tile by tile in plain integer arithmetic, reading
  only what a block stages, equals ``assemble_rgbd_plain(ycc_to_rgb_plain
  (...))`` to the bit on random planes;
- the wrapper refuses, before any launch, a resize whose single output's
  window cannot fit a block;
- the kernel's layout struct and constants are the plan's (both read as
  text).

The kernel itself runs only on a card: ``tests/test_torch_cuda.py``
(marked ``gpu``) and ``chip_smoke.py`` phase 32 hold it against the plain
version.
"""
import re

import numpy as np
import pytest
import torch

from creste_public_tpu_torch.ops import _build
from creste_public_tpu_torch.ops import frame_kernel as fk
from tests.test_torch_frame_io import SIZES

# (H, W, size) beside the frame tests' sizes: the reader's frame to a
# 16x downscale, a one-row output, a one-pixel upscale
CASES = dict(SIZES, **{
    "1024x1224-64x80": (1024, 1224, (64, 80)),
    "64x80-1x40": (64, 80, (1, 40)),
    "1x1-7x9": (1, 1, (7, 9)),
})
SUBSAMPLING = {"444": (1, 1), "422": (2, 1), "420": (2, 2)}


def _check_axis(bounds: np.ndarray, ext: np.ndarray, t: int, n_in: int,
                s: int) -> None:
    """Each output's window inside its tile's extent; the extents monotone
    and inside the plane; every chroma sample that fancy upsampling reads
    for the extent's luma samples inside the chroma extent."""
    n_c = -(-n_in // s)
    lo, hi, clo, chi = ext.T
    assert len(ext) == -(-len(bounds) // t)
    for o, (start, count) in enumerate(bounds):
        i = o // t
        assert lo[i] <= start and start + count <= hi[i], (o, i)
    assert (np.diff(lo) >= 0).all() and (np.diff(hi) >= 0).all()
    assert (0 <= lo).all() and (lo < hi).all() and (hi <= n_in).all()
    assert (0 <= clo).all() and (clo < chi).all() and (chi <= n_c).all()
    for i in range(len(ext)):
        x = np.arange(lo[i], hi[i])
        c = x // s
        read = [c] if s == 1 else [c, np.maximum(c - 1, 0),
                                   np.minimum(c + 1, n_c - 1)]
        read = np.concatenate(read)
        assert clo[i] <= read.min() and read.max() < chi[i], i


def _check_layout(plan: dict, kh: int, kv: int) -> None:
    """Every tile's parts fit the layout's, and the layout the budget."""
    lay = dict(zip(fk.PLAN_FIELDS, plan["layout"].tolist()))
    assert lay["bytes"] == plan["bytes"] <= fk.SMEM_BUDGET
    th, tw = lay["th"], lay["tw"]
    assert fk.TILE_THREADS % tw == 0
    assert th * tw <= fk.TILE_THREADS * fk.OUT_PER_THREAD
    for name in fk.PLAN_FIELDS[5:]:
        assert lay[name] % 16 == 0, name
    for r0, r1, cr0, cr1 in plan["rows"]:
        for c0, c1, cc0, cc1 in plan["cols"]:
            R, Rc = r1 - r0, cr1 - cr0
            assert c1 - c0 + 15 <= lay["luma_pitch"]
            assert cc1 - cc0 + 15 <= lay["chroma_pitch"]
            assert c1 - c0 <= lay["rgb_pitch"]
            assert R * lay["luma_pitch"] <= lay["cb"]
            assert Rc * lay["chroma_pitch"] <= lay["cr"] - lay["cb"]
            assert Rc * lay["chroma_pitch"] <= lay["rgb"] - lay["cr"]
            assert 4 * R * lay["rgb_pitch"] <= lay["hbuf"] - lay["rgb"]
            assert 4 * R * tw <= lay["hk"] - lay["hbuf"]
    assert 4 * kh * tw <= lay["hb"] - lay["hk"]
    assert 8 * tw <= lay["vk"] - lay["hb"]
    assert 4 * kv * th <= lay["vb"] - lay["vk"]
    assert 8 * th <= lay["nearest"] - lay["vb"]
    assert 4 * (th + tw) <= lay["lut"] - lay["nearest"]
    assert 4 * 256 <= lay["bytes"] - lay["lut"]


@pytest.mark.parametrize("sub", list(SUBSAMPLING))
@pytest.mark.parametrize("case", [*CASES, "axis-pairs-to-40"])
def test_plan_covers_every_window(case, sub):
    sh, sv = SUBSAMPLING[sub]
    if case == "axis-pairs-to-40":
        # the plan is made per axis: every length pair at each tile size
        # the shapes take on either axis
        for n_in in range(1, 41):
            for n_out in range(1, 41):
                bounds, _ = fk.bilinear_coeffs(n_in, n_out)
                for s in {sh, sv}:
                    for t in (1, 2, 4, 8, 16, 32, 64):
                        _check_axis(bounds, fk.axis_extents(bounds, t, n_in,
                                                            s), t, n_in, s)
        return
    H, W, size = CASES[case]
    h, w = fk.out_size(H, W, size)
    plan = fk.tile_plan(H, W, h, w, sh, sv)
    t = fk.frame_tables(H, W, h, w)
    lay = dict(zip(fk.PLAN_FIELDS, plan["layout"].tolist()))
    _check_axis(t["vbounds"], plan["rows"], lay["th"], H, sv)
    _check_axis(t["hbounds"], plan["cols"], lay["tw"], W, sh)
    _check_layout(plan, t["hweights"].shape[1], t["vweights"].shape[1])
    if (H, W, h, w) == (1024, 1224, 512, 612):
        assert (lay["th"], lay["tw"]) == fk.TILE_SHAPES[0]


def _fancy(c: np.ndarray, r: np.ndarray, x: np.ndarray, n_c: tuple,
           origin: tuple, sh: int, sv: int) -> np.ndarray:
    """libjpeg-turbo's fancy-upsampled chroma at luma rows r x columns x,
    read from ``c``, the staged part of a plane of n_c = (ch, cw) samples
    whose first row and column are ``origin``; every index checked inside
    the staged part."""
    ch, cw = n_c
    c = c.astype(np.int64)

    def at(rows, cols):
        rows, cols = rows - origin[0], cols - origin[1]
        assert rows.min() >= 0 and rows.max() < c.shape[0]
        assert cols.min() >= 0 and cols.max() < c.shape[1]
        return c[rows[:, None], cols[None, :]]

    cy, cx = r // sv, x // sh
    if sh == 1:
        return at(cy, cx)
    odd = (x % 2)[None, :]
    nx = np.where(x % 2 == 1, np.minimum(cx + 1, cw - 1),
                  np.maximum(cx - 1, 0))
    if sv == 1:
        return (3 * at(cy, cx) + at(cy, nx) + 1 + odd) >> 2
    ny = np.where(r % 2 == 1, np.minimum(cy + 1, ch - 1),
                  np.maximum(cy - 1, 0))
    s0 = 3 * at(cy, cx) + at(ny, cx)
    s1 = 3 * at(cy, nx) + at(ny, nx)
    return (3 * s0 + s1 + 8 - odd) >> 4


def _pass(x: np.ndarray, bounds: np.ndarray, weights: np.ndarray,
          lo: int) -> np.ndarray:
    """Pillow's 8-bpc pass along axis 1 of int [A, N, 3] for the outputs
    of ``bounds``, from an extent starting at input ``lo``."""
    out = np.empty((x.shape[0], len(bounds), 3), np.int64)
    for o, (start, count) in enumerate(bounds):
        s = start - lo
        assert 0 <= s and s + count <= x.shape[1]
        acc = (x[:, s:s + count] * weights[o, :count, None]).sum(1)
        out[:, o] = acc + (1 << (fk.PRECISION_BITS - 1))
    return np.clip(out >> fk.PRECISION_BITS, 0, 255)


def tile_walk(y, cb, cr, depth, size) -> np.ndarray:
    """What the kernel computes, tile by tile, from what each block stages
    (its luma and chroma extents), in plain integer arithmetic."""
    H, W = y.shape
    ch, cw = cb.shape
    sh, sv = fk.subsampling(H, W, ch, cw)
    h, w = fk.out_size(H, W, size)
    t = fk.frame_tables(H, W, h, w)
    plan = fk.tile_plan(H, W, h, w, sh, sv)
    th, tw = plan["layout"][:2]
    out = np.zeros((h, w, 4), np.float32)
    for ty, (r0, r1, cr0, cr1) in enumerate(plan["rows"]):
        for tx, (c0, c1, cc0, cc1) in enumerate(plan["cols"]):
            r, x = np.arange(r0, r1), np.arange(c0, c1)
            b = _fancy(cb[cr0:cr1, cc0:cc1], r, x, (ch, cw), (cr0, cc0),
                       sh, sv) - 128
            c = _fancy(cr[cr0:cr1, cc0:cc1], r, x, (ch, cw), (cr0, cc0),
                       sh, sv) - 128
            lum = y[r0:r1, c0:c1].astype(np.int64)
            half = 1 << 15
            rgb = np.clip(np.stack([
                lum + ((fk.CR_R * c + half) >> 16),
                lum + ((half - fk.CB_G * b - fk.CR_G * c) >> 16),
                lum + ((fk.CB_B * b + half) >> 16)], -1), 0, 255)
            xs = slice(tx * tw, min((tx + 1) * tw, w))
            ys = slice(ty * th, min((ty + 1) * th, h))
            hp = _pass(rgb, t["hbounds"][xs], t["hweights"][xs], c0)
            vp = _pass(hp.transpose(1, 0, 2), t["vbounds"][ys],
                       t["vweights"][ys], r0).transpose(1, 0, 2)
            out[ys, xs, :3] = vp.astype(np.float32) / np.float32(255.0)
            if depth is not None:
                out[ys, xs, 3] = depth[t["rows"][ys][:, None],
                                       t["cols"][xs][None, :]]
    return out


@pytest.mark.parametrize("sub", list(SUBSAMPLING))
@pytest.mark.parametrize("case", list(CASES))
def test_tile_walk_equals_plain(case, sub):
    H, W, size = CASES[case]
    sh, sv = SUBSAMPLING[sub]
    rng = np.random.default_rng(H * 7 + W + sh + 3 * sv)
    ch, cw = -(-H // sv), -(-W // sh)
    y = rng.integers(0, 256, (H, W), dtype=np.uint8)
    cb = rng.integers(0, 256, (ch, cw), dtype=np.uint8)
    cr = rng.integers(0, 256, (ch, cw), dtype=np.uint8)
    depth = rng.integers(0, 65536, (H, W)).astype(np.uint16)
    got = tile_walk(y, cb, cr, depth, size)
    planes = [torch.from_numpy(p) for p in (y, cb, cr)]
    want = fk.assemble_rgbd_plain(fk.ycc_to_rgb_plain(*planes),
                                  torch.from_numpy(depth), size).numpy()
    assert got.shape == want.shape
    assert np.array_equal(got, want), int((got != want).sum())


def test_wrapper_refuses_an_unfittable_window(monkeypatch):
    """1024x1224 -> 4x4: one output's window is 384 rows of 459 pixels,
    over a block's shared memory at any tile; the wrapper says so before
    it loads the library or launches."""
    def refuse():
        raise AssertionError("the wrapper loaded the kernel's library")

    monkeypatch.setattr(fk, "_lib", refuse)
    planes = (torch.zeros((1024, 1224), dtype=torch.uint8),
              torch.zeros((512, 612), dtype=torch.uint8),
              torch.zeros((512, 612), dtype=torch.uint8))
    before = fk.assemble_rgbd_cuda.launches
    with pytest.raises(ValueError, match=r"\[1024,1224\] to \[4,4\].* "
                       rf"over the {fk.SMEM_BUDGET} bytes"):
        fk.assemble_rgbd_cuda(planes, None, (4, 4))
    assert fk.assemble_rgbd_cuda.launches == before
    # the next size up fits, at a smaller tile than the reader's
    plan = fk.tile_plan(1024, 1224, 64, 80, 2, 2)
    assert tuple(plan["layout"][:2]) != fk.TILE_SHAPES[0]


def test_kernel_layout_is_the_plans():
    """``frame_io.cu``'s ``Layout`` lists ``PLAN_FIELDS`` in order, and its
    constants are the plan's (the source read as text)."""
    src = (_build.CSRC / "frame_io.cu").read_text()
    body = re.search(r"struct Layout \{(.*?)\};", src, re.S).group(1)
    assert re.findall(r"\w+", body.replace("int", "")) == list(
        fk.PLAN_FIELDS)
    for name, value in (("kThreads", fk.TILE_THREADS),
                        ("kOutPerThread", fk.OUT_PER_THREAD),
                        ("kMaxSharedBytes", fk.SMEM_BUDGET)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    assert "assemble_rgbd_kernel" in src and src.count("__global__") == 1
