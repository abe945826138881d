"""Tests of the port that need an NVIDIA GPU (marked ``gpu``; they skip
without one). This file imports no JAX, so on a machine without JAX it
runs on its own:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py
"""
import re

import pytest
import torch

from creste_public_tpu_torch import weights
from creste_public_tpu_torch.config import presets
from creste_public_tpu_torch.models.blocks.convnets import MultiScaleFCN
from creste_public_tpu_torch.ops import _build
from creste_public_tpu_torch.ops import reward_kernel as rk
from creste_public_tpu_torch.ops import svf, svf_kernel
from creste_public_tpu_torch.ops import value_iteration as vi
from creste_public_tpu_torch.ops.svf_kernel import expected_svf_cuda
from creste_public_tpu_torch.ops.vi_kernel import value_iteration_cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _reward_head(cuda):
    cfg = presets.traversability_model_config()["traversability_head"][
        "net_kwargs"]["reward_cfg"]["net_kwargs"]
    m = weights.jitter_reward_head_bns(
        weights.init_weights(MultiScaleFCN(cfg), 0), 1)
    return rk.fold_msfcn_params(m.to(cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 64, 128, 40), (3, 32, 64, 40),
                                   (2, 37, 53, 40)])
def test_reward_kernel_matches_plain_on_card(cuda, shape):
    """The CUDA reward head (3xTF32 on tensor cores) against its plain
    version (cuDNN, TF32 off) on the card: rtol 1e-4, atol 1e-5, and four
    launches per head."""
    folded = _reward_head(cuda)
    x = torch.randn(shape, generator=torch.Generator().manual_seed(0)).to(cuda)
    rk.msfcn_head_cuda.launches = 0
    got = rk.msfcn_fused_apply(folded, x)
    torch.cuda.synchronize()
    assert rk.msfcn_head_cuda.launches == 4
    ref = rk.msfcn_plain(folded, x)
    assert float((ref > 0).float().mean()) > 0.1
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
def test_reward_op_launches_the_kernel(cuda, tmp_path):
    """``creste::msfcn_head`` on CUDA tensors is the kernel: the same output
    as ``msfcn_head_cuda`` bit for bit, in four launches; and a fused tiny
    deployment graph exported with ``torch.export`` and reloaded calls it
    (four launches per frame), equal to the eager graph bit for bit."""
    from creste_public_tpu_torch.models.lfd import MaxEntIRL
    from creste_public_tpu_torch.runtime.compile import example_inputs
    from creste_public_tpu_torch.runtime.export import (
        build_inference_fn,
        export_inference_graph,
        load_exported,
    )

    folded = _reward_head(cuda)
    x = torch.randn(1, 64, 128, 40,
                    generator=torch.Generator().manual_seed(1)).to(cuda)
    rk.msfcn_head_cuda.launches = 0
    got = torch.ops.creste.msfcn_head(x, rk.head_tensors(folded))
    torch.cuda.synchronize()
    assert rk.msfcn_head_cuda.launches == 4
    assert torch.equal(got, rk.msfcn_head_cuda(folded, x))

    cfg = dict(presets.tiny_traversability_config().to_dict(),
               solve_mdp=False)
    model = weights.init_weights(MaxEntIRL(cfg), 0)
    weights.jitter_reward_head_bns(model.traversability_head.r, 1)
    rgbd, p2p = example_inputs(64, 80, depth_mm=3000.0)
    fn = build_inference_fn(cfg, model.state_dict(), "cuda")
    path = str(tmp_path / "g.pt2")
    xs = (torch.from_numpy(rgbd).to(cuda), torch.from_numpy(p2p).to(cuda))
    # compare with deterministic algorithms for cuDNN, and export under
    # them (a program keeps the cuDNN settings it was traced under); the
    # splat is its kernel, the same bits on every run
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        export_inference_graph(fn.graph, rgbd, p2p, path)
        module = load_exported(path).module()
        with torch.no_grad():
            eager = fn(*xs)
            rk.msfcn_head_cuda.launches = 0
            out = module(*xs)
            torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    assert rk.msfcn_head_cuda.launches == 4
    assert all(torch.equal(out[k], eager[k]) for k in eager)


@pytest.mark.gpu
def test_reward_kernel_rejects_bad_input(cuda):
    folded = _reward_head(cuda)
    with pytest.raises(ValueError, match="contiguous"):
        rk.msfcn_head_cuda(folded,
                           torch.zeros(1, 8, 8, 48, device=cuda)[..., :40])
    with pytest.raises(ValueError, match="float32"):
        rk.msfcn_head_cuda(folded, torch.zeros(1, 8, 8, 40, device=cuda,
                                               dtype=torch.float16))
    with pytest.raises(ValueError, match="multiple of 8"):
        rk.msfcn_head_cuda(folded, torch.zeros(1, 8, 8, 36, device=cuda))
    with pytest.raises(ValueError, match="channels"):
        rk.msfcn_head_cuda(folded, torch.zeros(1, 8, 8, 48, device=cuda))
    with pytest.raises(ValueError, match="on cuda"):
        rk.msfcn_head_cuda(_reward_head(torch.device("cpu")),
                           torch.zeros(1, 8, 8, 40, device=cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("shape,signed", [((10, 64, 128, 1), False),
                                          ((3, 16, 32, 1), True),
                                          ((20, 37, 53, 1), True)])
def test_vi_kernel_matches_plain_on_card(cuda, shape, signed):
    """The VI kernel against its plain version on the card: the same
    separate f32 roundings, so V agrees to the bit and the sweep counts are
    equal (chip_smoke.py holds them to 2e-3 + 1e-4|ref| and one sweep)."""
    g = torch.Generator().manual_seed(0)
    r = torch.rand(shape, generator=g)
    if signed:
        r = r - 0.6
        r[:, shape[1] // 2, shape[2] // 2] = 1.0
    r = r.to(cuda)
    value_iteration_cuda.launches = 0
    v = value_iteration_cuda(r)
    sweeps = int(value_iteration_cuda.sweeps.item())
    barriers = int(value_iteration_cuda.barriers.item())
    assert value_iteration_cuda.launches == 1
    ref = vi.value_iteration_plain(r)
    assert sweeps == vi.value_iteration_plain.sweeps
    assert 0 < sweeps < 2000
    k = int(re.search(r"constexpr int kSweepsPerBarrier = (\d+);",
                      (_build.CSRC / "value_iteration.cu").read_text()
                      ).group(1))
    assert barriers == -(-sweeps // k)
    torch.testing.assert_close(v, ref, rtol=0, atol=0)
    for cap in (7, 2 * k + 3, 0):
        vc = value_iteration_cuda(r, max_iters=cap)
        assert int(value_iteration_cuda.sweeps.item()) == cap
        torch.testing.assert_close(
            vc, vi.value_iteration_plain(r, max_iters=cap), rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,horizon", [((10, 64, 128, 8), 50),
                                           ((3, 17, 33, 8), 12),
                                           ((20, 37, 53, 8), 50),
                                           ((4, 5, 40, 8), 20),
                                           ((2, 8, 2048, 8), 12)])
@pytest.mark.parametrize("zts", [False, True])
def test_svf_kernel_matches_plain_on_card(cuda, shape, horizon, zts):
    """The SVF kernel against its plain version on the card, to the bit (the
    same separate f32 roundings in the same order), in one launch of one
    cluster of ``cluster_shape(H)`` blocks per element: the production
    shape, a ragged map, a batch of 20 clusters, H < 8, and a band of the
    most cells the kernel takes (above 48 KB of shared memory)."""
    g = torch.Generator().manual_seed(1)
    policy = torch.softmax(torch.randn(shape, generator=g) * 3, -1).to(cuda)
    B, H, W, _ = shape
    s0 = torch.randint(0, H * W, (B,), generator=g).to(cuda)
    s1 = torch.randint(0, H * W, (B,), generator=g).to(cuda)
    expected_svf_cuda.launches = 0
    got = svf.expected_svf(policy, s0, s1, horizon, zts)
    assert expected_svf_cuda.launches == 1
    C = svf_kernel.cluster_shape(H)[0]
    assert (expected_svf_cuda.cluster, expected_svf_cuda.blocks) == (C, B * C)
    assert expected_svf_cuda.clusters_at_once >= 1
    torch.testing.assert_close(
        got, svf.expected_svf_plain(policy, s0, s1, horizon, zts),
        rtol=0, atol=0)


@pytest.mark.gpu
def test_mdp_kernels_reject_bad_input(cuda):
    r = torch.zeros(2, 8, 8, 1, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        value_iteration_cuda(r.double())
    with pytest.raises(ValueError, match="contiguous"):
        value_iteration_cuda(torch.zeros(2, 8, 8, 2, device=cuda)[..., :1])
    with pytest.raises(ValueError, match=r"\[B,H,W,1\]"):
        value_iteration_cuda(torch.zeros(2, 8, 8, device=cuda))
    p = torch.full((2, 8, 8, 8), 1 / 8, device=cuda)
    s = torch.zeros(2, dtype=torch.long, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        expected_svf_cuda(p.half(), s, s, 3)
    with pytest.raises(ValueError, match="contiguous"):
        expected_svf_cuda(p.transpose(1, 2), s, s, 3)
    with pytest.raises(ValueError, match="device"):
        expected_svf_cuda(p, s.cpu(), s, 3)
    # a band of ceil(16 / 8) rows x 1025 = 2050 cells, over the 2048 limit
    with pytest.raises(ValueError, match="map size"):
        expected_svf_cuda(torch.full((1, 16, 1025, 8), 1 / 8, device=cuda),
                          s[:1], s[:1], 3)


def _masks(n_blocks: int, batch: int) -> list[torch.Tensor]:
    """Fixed drop-connect masks, zeros included, one per residual block."""
    g = torch.Generator().manual_seed(3)
    masks = [(torch.rand(batch, 1, 1, 1, generator=g) > 0.3).float()
             for _ in range(n_blocks)]
    masks[0][-1] = 0.0
    return masks


@pytest.mark.gpu
def test_train_step_on_card_matches_cpu(cuda):
    """One stage-3 training step at the tiny preset (residual trunk blocks,
    so drop-connect fires, with the same fed masks on both sides) on the
    card against the same step on the CPU: one VI and one SVF launch per
    step, the backbone's parameters bit unchanged, its running statistics
    and the loss and metrics as chip_smoke.py holds the card against the
    CPU (the statistics 1e-3 of their largest entry, STAGE_RTOL; the loss
    and metrics 1e-2 relative, FRAME_RTOL, since the splat's drift passes
    through the sharpened policy)."""
    from creste_public_tpu_torch.config.groups import GROUPS
    from creste_public_tpu_torch.data.dataloader import (
        EpochLoader,
        build_dataset,
    )
    from creste_public_tpu_torch.training import pipelines
    from creste_public_tpu_torch.training.loop import to_device

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = presets.tiny_traversability_config().to_dict()
    cfg["vision_backbone"]["vision_backbone"]["effnet_cfgs"][
        "stage_repeats"] = 2
    loader = EpochLoader(build_dataset(GROUPS["dataset"]["synthetic_tiny"],
                                       "train"), 2, num_workers=1)
    batches = list(loader.epoch(0))
    masks = _masks(5, 2)
    runs = {}
    for dev in (cuda, torch.device("cpu")):
        model, lm, state = pipelines.init_stage(
            "traversability", cfg, steps_per_epoch=2, device=dev)
        step = pipelines.make_train_step("traversability", model, lm)
        before = {k: v.clone() for k, v in model.state_dict().items()}
        fed = iter(masks * len(batches))
        launches = []
        metrics = []
        for b in batches:
            value_iteration_cuda.launches = expected_svf_cuda.launches = 0
            metrics.append(step(state, to_device(b, dev),
                                lambda batch, keep: next(fed)))
            launches.append((value_iteration_cuda.launches,
                             expected_svf_cuda.launches))
        runs[dev.type] = (before, model.state_dict(), metrics, launches)
    before, after, metrics, launches = runs["cuda"]
    c_before, c_after, c_metrics, c_launches = runs["cpu"]
    assert launches == [(1, 1)] * len(batches)
    assert c_launches == [(0, 0)] * len(batches)
    for k, v in before.items():
        assert torch.equal(v.cpu(), c_before[k]), k
        if k.startswith("backbone") and "running" not in k:
            assert torch.equal(after[k], v), k
        if k.startswith("backbone") and "running" in k:
            assert not torch.equal(after[k], v), k
            d = float((after[k].cpu() - c_after[k]).abs().max())
            assert d <= 1e-3 * float(c_after[k].abs().max()), k
    for m, cm in zip(metrics, c_metrics):
        assert m.keys() == cm.keys()
        for k in cm:
            torch.testing.assert_close(m[k].cpu(), cm[k], rtol=1e-2,
                                       atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("H,W,size,sub", [
    (1024, 1224, (512, 612), (2, 2)), (64, 80, (37, 53), (2, 2)),
    (32, 40, (64, 80), (2, 1)), (63, 81, (64, 40), (2, 2)),
    (64, 80, None, (1, 1))])
@pytest.mark.parametrize("with_depth", [True, False])
def test_frame_kernel_matches_plain_on_card(cuda, H, W, size, sub,
                                            with_depth):
    """``assemble_rgbd`` on the card equals its plain version
    (``ycc_to_rgb_plain`` then ``assemble_rgbd_plain``) to the bit, in one
    launch, from random planes at 4:2:0, 4:2:2 and 4:4:4 (odd sizes
    included)."""
    from creste_public_tpu_torch.ops import frame_kernel as fk

    g = torch.Generator().manual_seed(H + W)
    ch, cw = -(-H // sub[1]), -(-W // sub[0])
    planes = [torch.randint(0, 256, shape, generator=g, dtype=torch.uint8)
              for shape in ((H, W), (ch, cw), (ch, cw))]
    depth = (torch.randint(0, 65536, (H, W), generator=g,
                           dtype=torch.int32).to(torch.uint16)
             if with_depth else None)
    before = fk.assemble_rgbd_cuda.launches
    got = fk.assemble_rgbd_cuda([p.to(cuda) for p in planes],
                                None if depth is None else depth.to(cuda),
                                size)
    torch.cuda.synchronize()
    assert fk.assemble_rgbd_cuda.launches == before + 1
    want = fk.assemble_rgbd_plain(fk.ycc_to_rgb_plain(*planes), depth, size)
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
def test_device_decoder_matches_pil_reader(cuda, tmp_path):
    """nvJPEG + the kernel against the reader's PIL path on one JPEG and
    depth PNG: the depth channel equal, the RGB within the decode limits
    of chip_smoke phase 32 (in uint8 levels: max |d| <= 8, mean <= 0.3,
    share of pixels more than 1 level off <= 2%)."""
    import numpy as np
    from PIL import Image

    from creste_public_tpu_torch.data import native_io
    from creste_public_tpu_torch.data.coda_dataset import CodaDataset
    from creste_public_tpu_torch.ops import frame_kernel as fk

    rng = np.random.default_rng(0)
    H, W = 256, 320
    u = np.linspace(0, 1, W)[None, :, None]
    v = np.linspace(0, 1, H)[:, None, None]
    rgb = np.clip(0.5 * rng.uniform(0, 255, (H, W, 3)) + 60 * (u + v), 0,
                  255).astype(np.uint8)
    depth = rng.integers(0, 65536, (H, W)).astype(np.uint16)
    jpg, png = str(tmp_path / "f.jpg"), str(tmp_path / "f.png")
    Image.fromarray(rgb).save(jpg, quality=90)
    Image.fromarray(depth).save(png)
    decoder = native_io.DeviceFrameDecoder(cuda)
    before = fk.assemble_rgbd_cuda.launches
    got = decoder.assemble(jpg, png, (128, 160))
    assert fk.assemble_rgbd_cuda.launches == before + 1
    stub = type("Reader", (), {"image_size": (128, 160)})()
    r, d = CodaDataset._resized(stub, native_io.decode_jpeg(jpg).astype(
        np.float32) / 255.0, native_io.decode_png16(png).astype(np.float32))
    assert got.shape == (128, 160, 4) and got.dtype == np.float32
    assert np.array_equal(got[..., 3], d)
    diff = np.rint(np.abs(got[..., :3].astype(np.float64) - r) * 255)
    assert diff.max() <= 8 and diff.mean() <= 0.3
    assert (diff > 1).mean() <= 0.02


@pytest.mark.gpu
def test_frame_kernel_rejects_bad_input(cuda):
    import numpy as np

    from creste_public_tpu_torch.ops import frame_kernel as fk

    y = torch.zeros((8, 8), dtype=torch.uint8, device=cuda)
    c = torch.zeros((4, 4), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        fk.assemble_rgbd_cuda((y.t(), c, c), None, (4, 4))
    with pytest.raises(ValueError, match="device"):
        fk.assemble_rgbd_cuda((y, c, c),
                              torch.zeros((8, 8), dtype=torch.uint16), (4, 4))
    with pytest.raises(ValueError, match="positive"):
        fk.assemble_rgbd_cuda((y, c, c), None, (0, 4))
    decoder = fk.JpegDecoder(cuda)
    try:
        with pytest.raises(RuntimeError, match="nvjpeg"):
            decoder.decode(np.frombuffer(b"not a jpeg", np.uint8).copy())
    finally:
        decoder.close()


@pytest.mark.gpu
def test_device_decoder_threads(cuda, tmp_path):
    """More threads than cores decode through one decoder at once (each
    takes a context of its own): every result equals the serial one, and
    every launch is counted."""
    import os
    import sys
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from PIL import Image

    from creste_public_tpu_torch.data import native_io
    from creste_public_tpu_torch.ops import frame_kernel as fk

    rng = np.random.default_rng(1)
    pairs = []
    for i in range(4):
        jpg, png = str(tmp_path / f"{i}.jpg"), str(tmp_path / f"{i}.png")
        Image.fromarray(rng.integers(0, 256, (128, 160, 3), dtype=np.uint8)
                        ).save(jpg, quality=90)
        Image.fromarray(rng.integers(0, 65536, (128, 160)).astype(
            np.uint16)).save(png)
        pairs.append((jpg, png))
    decoder = native_io.DeviceFrameDecoder(cuda)
    want = [decoder.assemble(j, p, (64, 80)) for j, p in pairs]
    n = 2 * (os.cpu_count() or 4)
    before = fk.assemble_rgbd_cuda.launches
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ThreadPoolExecutor(n) as pool:
            futures = [pool.submit(decoder.assemble, *pairs[i % 4], (64, 80))
                       for i in range(4 * n)]
            got = [f.result(timeout=120) for f in futures]
    finally:
        sys.setswitchinterval(interval)
    assert fk.assemble_rgbd_cuda.launches == before + 4 * n
    for i, g in enumerate(got):
        assert np.array_equal(g, want[i % 4]), i


def _splat_points(seed, B, P, F, H, W):
    g = torch.Generator().manual_seed(seed)
    xy = torch.rand(B, P, 2, generator=g) * torch.tensor([W + 4.0, H + 4.0])
    return xy - 2.0, torch.randn(B, P, F, generator=g)


@pytest.mark.gpu
@pytest.mark.parametrize("B,P,F,H,W", [(1, 19584, 96, 256, 256),
                                       (2, 1001, 16, 61, 67),
                                       (1, 4000, 0, 32, 32)])
def test_splat_kernel_equals_cpu_plain_to_the_bit(cuda, B, P, F, H, W):
    """``splat_sums_cuda`` equals the plain version run on the CPU from the
    same inputs to the bit, three launches equal each other, and
    ``creste::splat_sums`` on CUDA tensors is the kernel (one launch)."""
    from creste_public_tpu_torch.ops import splat as ts
    from creste_public_tpu_torch.ops import splat_kernel as sk

    xy, f = _splat_points(B + P, B, P, F, H, W)
    want = ts.splat_sums_plain(xy, f, (H, W))
    xy_d, f_d = xy.to(cuda), f.to(cuda)
    runs = [sk.splat_sums_cuda(xy_d, f_d, (H, W)).cpu() for _ in range(3)]
    for got in runs:
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    sk.splat_sums_cuda.launches = 0
    got = torch.ops.creste.splat_sums(xy_d, f_d, H, W)
    torch.cuda.synchronize()
    assert sk.splat_sums_cuda.launches == 1
    assert torch.equal(got.cpu(), runs[0])


@pytest.mark.gpu
def test_splat_kernel_rejects_bad_input(cuda):
    from creste_public_tpu_torch.ops import splat_kernel as sk

    xy, f = torch.zeros(1, 8, 2, device=cuda), torch.zeros(1, 8, 3,
                                                          device=cuda)
    with pytest.raises(ValueError, match="float32"):
        sk.splat_sums_cuda(xy.double(), f, (4, 4))
    with pytest.raises(ValueError, match="contiguous"):
        sk.splat_sums_cuda(xy, torch.zeros(1, 8, 6, device=cuda)[..., :3],
                           (4, 4))
    with pytest.raises(ValueError, match="does not match"):
        sk.splat_sums_cuda(xy, f[:, :4], (4, 4))
