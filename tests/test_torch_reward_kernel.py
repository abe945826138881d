"""The port's folded reward head (ops/reward_kernel.py) against the JAX
package: the Pallas kernel in interpret mode and the flax MultiScaleFCN.

On the CPU the head runs its plain PyTorch version; the CUDA kernel is held
against that version on the card by chip_smoke.py. Here its arithmetic is
emulated: the launch split with its tiles and halos (read from
csrc/msfcn_chain.cu), and the 3xTF32 split of its tensor-core products.
Tolerance: rtol 1e-4, atol 1e-5 (f32; the BN fold reassociates the affine
and sums run in another order), as the JAX package's own fused-head test.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from creste_public_tpu.config import presets as jpresets
from creste_public_tpu.models.blocks.convnets import MultiScaleFCN as JFCN
from creste_public_tpu.ops.reward_pallas import msfcn_fused_apply as jfused
from creste_public_tpu_torch import weights
from creste_public_tpu_torch.config import presets
from creste_public_tpu_torch.models.blocks.convnets import MultiScaleFCN
from creste_public_tpu_torch.ops import _build
from creste_public_tpu_torch.ops import reward_kernel as rk
from creste_public_tpu_torch.weights import load_jax_variables
from tests.test_torch_helpers import flat_variables, jax_variables, jitter_bn

RTOL, ATOL = 1e-4, 1e-5
CU = Path(rk.__file__).resolve().parent.parent / "csrc" / "msfcn_chain.cu"


def _head_cfg():
    cfg = jpresets.traversability_model_config().to_dict()
    return cfg["traversability_head"]["net_kwargs"]["reward_cfg"]["net_kwargs"]


@pytest.mark.parametrize("shape", [(1, 64, 128, 40), (3, 32, 64, 40)])
def test_fused_head_matches_pallas_and_flax(shape):
    cfg = _head_cfg()
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    jm = JFCN(cfg)
    flat = jitter_bn(flat_variables(
        jm.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x))))
    jv = jax_variables(flat)
    ref_flax = np.asarray(jm.apply(jv, jnp.asarray(x), False))
    ref_pallas = np.asarray(jfused(jv, jnp.asarray(x), interpret=True))

    m = load_jax_variables(MultiScaleFCN(cfg), flat).eval()
    folded = rk.fold_msfcn_params(m)
    rk.msfcn_head_cuda.launches = 0
    got = rk.msfcn_fused_apply(folded, torch.from_numpy(x)).numpy()
    assert rk.msfcn_head_cuda.launches == 0  # CPU tensors: plain version
    assert got.shape == ref_flax.shape == shape[:3] + (1,)
    np.testing.assert_allclose(got, ref_pallas, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, ref_flax, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        rk.msfcn_plain(folded, torch.from_numpy(x)).numpy(), got, rtol=0,
        atol=0)


def test_fold_matches_jax_fold():
    """Per-layer (kernel, a, b, pre_relu) equal the JAX package's fold."""
    from creste_public_tpu.ops.reward_pallas import fold_msfcn_params

    cfg = _head_cfg()
    jm = JFCN(cfg)
    flat = jitter_bn(flat_variables(jm.init(
        {"params": jax.random.PRNGKey(1)}, jnp.zeros((1, 8, 8, 40)))))
    jv = jax_variables(flat)
    jf = fold_msfcn_params(jv["params"], jv["batch_stats"])
    tf = rk.fold_msfcn_params(
        load_jax_variables(MultiScaleFCN(cfg), flat).eval())
    assert [len(tf[k]) for k in jf] == [2, 2, 2, 1]
    for k in jf:
        for j, t in zip(jf[k], tf[k]):
            np.testing.assert_array_equal(t["kernel"].numpy(),
                                          np.asarray(j["kernel"]))
            np.testing.assert_allclose(t["a"].numpy(), np.asarray(j["ab"][0]),
                                       rtol=1e-6)
            np.testing.assert_allclose(t["b"].numpy(), np.asarray(j["ab"][1]),
                                       rtol=1e-6, atol=1e-7)
            assert t["pre_relu"] == j["pre_relu"] and t["post_relu"]


def _layer(ci=4, co=3, k=3):
    g = torch.Generator().manual_seed(0)
    return {"kernel": torch.randn(k, k, ci, co, generator=g),
            "a": torch.rand(co, generator=g), "b": torch.randn(co, generator=g),
            "pre_relu": True, "post_relu": True}


def test_plain_layer_matches_direct_sum():
    """conv_affine_plain == the tap-by-tap sum the kernel computes."""
    ly = _layer()
    x = torch.randn(2, 5, 6, 4, generator=torch.Generator().manual_seed(1))
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    acc = sum(xp[:, dy:dy + 5, dx:dx + 6, :] @ ly["kernel"][dy, dx]
              for dy in range(3) for dx in range(3))
    want = torch.relu(torch.relu(acc) * ly["a"] + ly["b"])
    torch.testing.assert_close(rk.conv_affine_plain(x, ly), want, rtol=1e-5,
                               atol=1e-5)


def test_cuda_wrapper_refuses_non_cuda_tensors():
    folded = rk.fold_msfcn_params(_head(_tiny_head_cfg(), 0))
    rk.msfcn_head_cuda.launches = 0
    with pytest.raises(ValueError, match="CUDA"):
        rk.msfcn_head_cuda(folded, torch.zeros(1, 8, 16, 16))
    meta = torch.zeros(1, 8, 16, 16, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        rk.msfcn_fused_apply(folded, meta)  # not CPU: never the plain version
    rk.msfcn_fused_apply(folded, torch.zeros(1, 8, 16, 16))
    assert rk.msfcn_head_cuda.launches == 0


def test_folded_head_is_read_only():
    """The folded head cannot be changed after the wrapper has taken its
    pointers; ``to`` copies it, and the wrapper takes nothing else."""
    folded = rk.fold_msfcn_params(_head(_tiny_head_cfg(), 0))
    with pytest.raises(TypeError):
        folded["prepool"] = []
    with pytest.raises(TypeError):
        folded["prepool"][0]["a"] = torch.zeros(1)
    with pytest.raises(TypeError):
        folded["prepool"][0] = {}
    moved = folded.to("cpu")
    assert isinstance(moved, rk.FoldedHead) and list(moved) == list(folded)
    for chain in folded:
        for a, b in zip(folded[chain], moved[chain], strict=True):
            assert a.keys() == b.keys()
            assert all(torch.equal(a[k], b[k]) for k in ("kernel", "a", "b"))
    with pytest.raises(TypeError, match="fold_msfcn_params"):
        rk.msfcn_head_cuda(dict(folded), torch.zeros(1, 8, 16, 16))


def _tiny_head_cfg():
    return presets.tiny_traversability_config()["traversability_head"][
        "net_kwargs"]["reward_cfg"]["net_kwargs"]


def _head(cfg, seed):
    """Seeded weights with BN shifts jittered so that every relu is alive."""
    return weights.jitter_reward_head_bns(
        weights.init_weights(MultiScaleFCN(cfg), seed), seed + 1).eval()


def _cu_ints(*names):
    src = CU.read_text()
    return [int(re.search(rf"\b{n} = (\d+)", src).group(1)) for n in names]


def test_kernel_source_widths_match_head():
    """The widths compiled into the kernel are the wrapper's HEAD and the
    presets' (production and tiny), so the wrapper's check is the kernel's."""
    c1, c2, c3, c4, c5, c6 = _cu_ints("kC1", "kC2", "kC3", "kC4", "kC5",
                                      "kC6")
    h = rk.HEAD
    assert [co for *_, co, _ in h["prepool"]] == [c1, c2]
    assert [co for *_, co, _ in h["skip"]] == [c3, c4]
    assert [co for *_, co, _ in h["trunk"]] == [c5, c6]
    assert h["postpool"][0][1] == c6 + c4
    for cfg in (_head_cfg(), _tiny_head_cfg()):
        m = MultiScaleFCN(cfg)
        folded = rk.fold_msfcn_params(m)
        for chain, want in h.items():
            for ly, (k, ci, co, pre) in zip(folded[chain], want, strict=True):
                kh, kw, lci, lco = ly["kernel"].shape
                assert (kh == kw == k or k is None) and lco == co
                assert (lci == ci or ci is None) and ly["pre_relu"] == pre
                assert ("packed" in ly) == (chain != "postpool")


def test_packed_fragments_layout():
    """pack_tf32_fragments puts w[k, n] of each 8x8 block of (ci, co) where
    mma.m16n8k8's B fragment wants it: lane 4n + k holds (hi[k], hi[k+4],
    lo[k], lo[k+4]); hi + lo rebuilds w to ~2^-22 of its scale."""
    g = torch.Generator().manual_seed(3)
    w = torch.randn(3, 3, 16, 24, generator=g)
    p = rk.pack_tf32_fragments(w).reshape(9, 2, 3, 32, 4)
    hi = rk.tf32_round(w)
    lo = rk.tf32_round(w - hi)
    for tap, ks, nt, lane in [(0, 0, 0, 0), (4, 1, 2, 13), (8, 1, 1, 31),
                              (5, 0, 2, 22)]:
        n, k = divmod(lane, 4)
        dy, dx = divmod(tap, 3)
        ci, co = ks * 8 + k, nt * 8 + n
        assert p[tap, ks, nt, lane].tolist() == [
            hi[dy, dx, ci, co], hi[dy, dx, ci + 4, co], lo[dy, dx, ci, co],
            lo[dy, dx, ci + 4, co]]
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert not (lo.view(torch.int32) & 0x1FFF).any()
    assert float((hi + lo - w).abs().max()) <= 2**-21 * float(w.abs().max())


def test_3xtf32_split_on_production_layer():
    """The kernel's 3xTF32 product (hi*hi + hi*lo + lo*hi, operands rounded
    to nearest at 10 mantissa bits) on the production-width 5x5 40 -> 64
    layer at 64x128 stays within 1e-5 + 1e-4|ref| of the f32 layer."""
    folded = rk.fold_msfcn_params(_head(_head_cfg(), 0))
    ly = folded["prepool"][0]
    assert tuple(ly["kernel"].shape) == (5, 5, 40, 64)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(1, 64, 128, 40)).astype(np.float32))
    xh = rk.tf32_round(x)
    xl = rk.tf32_round(x - xh)
    wh = rk.tf32_round(ly["kernel"])
    wl = rk.tf32_round(ly["kernel"] - wh)

    def conv(a, w):
        return torch.nn.functional.conv2d(a.permute(0, 3, 1, 2),
                                          w.permute(3, 2, 0, 1), padding=2)

    y = conv(xl, wh) + conv(xh, wl) + conv(xh, wh)
    y = torch.relu(y * ly["a"][:, None, None] + ly["b"][:, None, None])
    ref = rk.conv_affine_plain(x, ly)
    got = y.permute(0, 2, 3, 1)
    torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL)
    # a single TF32 pass does not hold: the reason for three
    y1 = torch.relu(conv(xh, wh) * ly["a"][:, None, None]
                    + ly["b"][:, None, None]).permute(0, 2, 3, 1)
    assert not bool(((y1 - ref).abs() <= ATOL + RTOL * ref.abs()).all())


def _gather(m, y0, x0, th, tw):
    """th x tw pixels of the [H, W, C] map m at (y0, x0), 0 outside."""
    H, W, C = m.shape
    out = torch.zeros(th, tw, C)
    ya, yb = max(y0, 0), min(y0 + th, H)
    xa, xb = max(x0, 0), min(x0 + tw, W)
    if ya < yb and xa < xb:
        out[ya - y0:yb - y0, xa - x0:xb - x0] = m[ya:yb, xa:xb]
    return out


def _in_map(y0, x0, th, tw, H, W):
    ys, xs = torch.arange(y0, y0 + th), torch.arange(x0, x0 + tw)
    return (((ys >= 0) & (ys < H))[:, None]
            & ((xs >= 0) & (xs < W))[None, :])[..., None]


def _valid(t, ly):
    """One folded layer without padding on a [h, w, C] tile."""
    y = torch.nn.functional.conv2d(t.permute(2, 0, 1)[None],
                                   ly["kernel"].permute(3, 2, 0, 1))[0]
    if ly["pre_relu"]:
        y = torch.relu(y)
    y = torch.relu(y * ly["a"][:, None, None] + ly["b"][:, None, None])
    return y.permute(1, 2, 0)


def _emulate_launches(folded, x):
    """The kernel's four launches with their tiles and halos: (1) the first
    layer on kTile1 tiles; (2) 3x3 on kTile2 tiles + 1-pixel halo (0 outside
    the map), the 2x2 maxpool of the tile, the skip's 3x3 and 1x1; (3) the
    trunk on kTile3 half-resolution tiles; (4) per pixel, the resize as
    the kernel computes it, concat and the final 1x1."""
    t1h, t1w, t2h, t2w, t3h, t3w = _cu_ints(
        "kTile1H", "kTile1W", "kTile2H", "kTile2W", "kTile3H", "kTile3W")
    (P0, P1), (S0, S1) = folded["prepool"], folded["skip"]
    (T0, T1), (post,) = folded["trunk"], folded["postpool"]
    B, H, W, _ = x.shape
    Hp, Wp = H // 2, W // 2
    h = P0["kernel"].shape[0] // 2
    p0 = torch.zeros(B, H, W, 64)
    s = torch.zeros(B, H, W, 16)
    pooled = torch.zeros(B, Hp, Wp, 32)
    t = torch.zeros(B, Hp, Wp, 32)
    for b in range(B):
        for y0 in range(0, H, t1h):
            for x0 in range(0, W, t1w):
                o = _valid(_gather(x[b], y0 - h, x0 - h, t1h + 2 * h,
                                   t1w + 2 * h), P0)
                p0[b, y0:y0 + t1h, x0:x0 + t1w] = o[:H - y0, :W - x0]
        for y0 in range(0, H, t2h):
            for x0 in range(0, W, t2w):
                tp = _valid(_gather(p0[b], y0 - 2, x0 - 2, t2h + 4, t2w + 4),
                            P1) * _in_map(y0 - 1, x0 - 1, t2h + 2, t2w + 2,
                                          H, W)
                inner = tp[1:1 + t2h, 1:1 + t2w]
                win = inner.reshape(t2h // 2, 2, t2w // 2, 2, -1).amax((1, 3))
                gy, gx = y0 // 2, x0 // 2
                pooled[b, gy:gy + t2h // 2, gx:gx + t2w // 2] = \
                    win[:Hp - gy, :Wp - gx]
                o = _valid(_valid(tp, S0), S1)
                s[b, y0:y0 + t2h, x0:x0 + t2w] = o[:H - y0, :W - x0]
        for y0 in range(0, Hp, t3h):
            for x0 in range(0, Wp, t3w):
                o = _valid(_valid(_gather(pooled[b], y0 - 1, x0 - 1, t3h + 2,
                                          t3w + 2), T0), T1)
                t[b, y0:y0 + t3h, x0:x0 + t3w] = o[:Hp - y0, :Wp - x0]

    def src(n_out, n_in):  # F.interpolate(align_corners=False) indices
        f = torch.clamp(torch.tensor(np.float32(n_in) / np.float32(n_out))
                        * (torch.arange(n_out, dtype=torch.float32) + 0.5)
                        - 0.5, min=0)
        i0 = f.floor().long()
        i1 = torch.where(i0 < n_in - 1, i0 + 1, i0)
        return i0, i1, f - i0
    y0i, y1i, ly1 = src(H, Hp)
    x0i, x1i, lx1 = src(W, Wp)
    ly1, lx1 = ly1[:, None, None], lx1[None, :, None]
    up = ((1 - ly1) * ((1 - lx1) * t[:, y0i][:, :, x0i]
                       + lx1 * t[:, y0i][:, :, x1i])
          + ly1 * ((1 - lx1) * t[:, y1i][:, :, x0i]
                   + lx1 * t[:, y1i][:, :, x1i]))
    z = torch.cat([up, s], -1) @ post["kernel"][0, 0]
    return torch.relu(z * post["a"] + post["b"])


@pytest.mark.parametrize("case", ["tiny_preset", "ragged"])
def test_launch_split_emulation_matches_plain(case):
    """The kernel's launch split, tiles, halos, fused maxpool (floor) and
    resize at the ragged edges give the plain head's output."""
    if case == "tiny_preset":
        cfg, shape = _tiny_head_cfg(), (2, 8, 16, 16)
    else:
        cfg, shape = _head_cfg(), (2, 37, 53, 40)
    folded = rk.fold_msfcn_params(_head(cfg, 2))
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=shape).astype(np.float32))
    ref = rk.msfcn_plain(folded, x)
    got = _emulate_launches(folded, x)
    assert got.shape == ref.shape == shape[:3] + (1,)
    assert float((ref > 0).float().mean()) > 0.3  # the final relu is alive
    torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL)


def test_kernel_build_needs_nvcc(monkeypatch):
    """Without nvcc the build raises; it never falls back to the plain
    version."""
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    if any(_build.library_path(n).exists() for n in _build.sources()):
        pytest.skip("a built kernel library is present")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()
    assert _build.sources() == ["frame_io", "msfcn_chain", "splat", "svf",
                                "value_iteration"]
