"""The CODa reader's frame assembly on the card (``ops/frame_kernel.py``,
``csrc/frame_io.cu``), on the CPU: what can be held here without a card.

- ``assemble_rgbd_plain`` (the kernel's function in torch integer ops)
  equals the reader's PIL path (``CodaDataset._resized``: BILINEAR on the
  uint8 RGB, NEAREST on the f32 depth) bit for bit at 1024x1224 ->
  512x612, 64x80 -> 37x53, 32x40 -> 64x80, 64x80 -> 64x40 and the
  identity, with and without a depth map (tolerance 0);
- ``bilinear_coeffs`` has Pillow's support and weights at 1024 -> 512 and
  1224 -> 612, and ``nearest_index`` Pillow's indices at every size pair
  up to 60 (read back from PIL's own NEAREST resize of an index image);
- on the tiny CODa tree the plain assembly of the PIL-decoded frame is
  the JAX reader's ``image`` (its PIL branch), resized and not;
- a reader asked for the card raises here, where there is none, and a
  loader in process mode refuses a reader that decodes on a card;
- the nvcc command of ``frame_io`` links nvJPEG and no other source's does
  (checked without nvcc);
- ``ycc_to_rgb_plain`` (libjpeg-turbo's fancy upsampling and fixed-point
  YCbCr -> RGB, from nvJPEG's planes) gives PIL's RGB to the bit at 4:2:0,
  4:2:2 and 4:4:4, from planes known exactly;
- the kernel's wrapper refuses CPU tensors, wrong dtypes and chroma
  sizes before any library is loaded.

The kernel itself runs only on a card: ``tests/test_torch_cuda.py`` (marked
``gpu``) and ``chip_smoke.py`` phase 32 hold it against the plain version.
"""
import io
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from PIL import Image

from creste_public_tpu.data import coda_dataset as jcd
from creste_public_tpu.data import native_io as jnative_io
from creste_public_tpu_torch.data import coda_dataset as cd
from creste_public_tpu_torch.data import native_io
from creste_public_tpu_torch.data.dataloader import EpochLoader, build_dataset
from creste_public_tpu_torch.ops import _build
from creste_public_tpu_torch.ops import frame_kernel as fk
from tests.test_torch_coda_tree import write_coda_tree

# (H, W, size): size None is the reader's image_size None (no resize)
SIZES = {
    "1024x1224-512x612": (1024, 1224, (512, 612)),
    "64x80-37x53": (64, 80, (37, 53)),
    "32x40-64x80": (32, 40, (64, 80)),
    "64x80-64x40": (64, 80, (64, 40)),
    "identity": (64, 80, None),
}


def frame(H: int, W: int, seed: int = 0):
    """A noisy gradient RGB frame (uint8) and a depth map in mm (uint16)
    with holes and the full 16-bit range."""
    rng = np.random.default_rng(seed)
    u = np.linspace(0, 1, W)[None, :, None]
    v = np.linspace(0, 1, H)[:, None, None]
    rgb = np.clip(0.5 * rng.uniform(0, 255, (H, W, 3)) + 90 * (u + v), 0,
                  255).astype(np.uint8)
    depth = rng.integers(0, 65536, (H, W)).astype(np.uint16)
    depth[rng.uniform(size=(H, W)) < 0.3] = 0
    return rgb, depth


def pil_path(rgb: np.ndarray, depth: np.ndarray | None, size):
    """The port reader's CPU path: ``_image``'s /255, ``_depth_png``'s f32,
    ``_resized`` and the concatenation (a zero depth channel without a
    depth map, as ``native_io.assemble_rgbd``)."""
    d = (np.zeros(rgb.shape[:2], np.float32) if depth is None
         else depth.astype(np.float32))
    r, d = cd.CodaDataset._resized(SimpleNamespace(image_size=size),
                                   rgb.astype(np.float32) / 255.0, d)
    return np.concatenate([r, d[..., None]], axis=-1)


@pytest.mark.parametrize("with_depth", [True, False],
                         ids=["depth", "no_depth"])
@pytest.mark.parametrize("name", list(SIZES))
def test_plain_equals_pil(name, with_depth):
    H, W, size = SIZES[name]
    rgb, depth = frame(H, W)
    got = fk.assemble_rgbd_plain(torch.from_numpy(rgb),
                                 torch.from_numpy(depth) if with_depth
                                 else None, size).numpy()
    want = pil_path(rgb, depth if with_depth else None, size)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape == ((H, W) if size is None
                                       else tuple(size)) + (4,)
    assert np.array_equal(got, want), int((got != want).sum())


def test_bilinear_coeffs_have_pillows_support():
    """At 1024 -> 512 and 1224 -> 612 (scale 2): support 2, so five
    weights a row; inside, the window of four with the triangle's 1:3:3:1;
    at the edges the clipped window of three renormalised; every row sums
    to 2^22 (to within its rounding)."""
    one = 1 << fk.PRECISION_BITS
    for n_in, n_out in ((1024, 512), (1224, 612)):
        bounds, weights = fk.bilinear_coeffs(n_in, n_out)
        assert bounds.shape == (n_out, 2) and weights.shape == (n_out, 5)
        assert bounds.dtype == weights.dtype == np.int32
        assert np.abs(weights.sum(1) - one).max() <= 2
        inner = [one // 8, 3 * one // 8, 3 * one // 8, one // 8, 0]
        assert (weights[1:-1] == inner).all()
        assert (bounds[1:-1, 0] == 2 * np.arange(1, n_out - 1) - 1).all()
        assert (bounds[1:-1, 1] == 4).all()
        edge = [int(0.5 + k / 1.75 * one) for k in (0.75, 0.75, 0.25)]
        assert weights[0].tolist() == edge + [0, 0]
        assert weights[-1].tolist() == edge[::-1] + [0, 0]
        assert bounds[0].tolist() == [0, 3]
        assert bounds[-1].tolist() == [n_in - 3, 3]


def test_nearest_index_is_pillows():
    """Every size pair up to 60: the index Pillow's NEAREST reads, from
    its resize of an image whose pixels are their own column."""
    for n_in in range(1, 61):
        src = Image.fromarray(np.arange(n_in, dtype=np.int32)[None], "I")
        for n_out in range(1, 61):
            want = np.asarray(src.resize((n_out, 1), Image.NEAREST))[0]
            assert np.array_equal(fk.nearest_index(n_in, n_out), want), (
                n_in, n_out)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("coda_frames"))
    write_coda_tree(root, labels3d=False, scans=False, missing_sam=None)
    return root


@pytest.mark.parametrize("image_size", [None, [48, 60]],
                         ids=["native", "resized"])
def test_plain_assembly_equals_jax_reader(tree, image_size, monkeypatch):
    monkeypatch.setattr(jnative_io, "available", lambda: False)
    cfg = {"name": "coda", "root": tree, "grid": 32, "map_range": 1.6,
           "horizon": 10, "image_size": image_size}
    want = jcd.CodaDataset(cfg, split="train")
    port = cd.CodaDataset(cfg, split="train", device="cpu")
    assert len(want) > 0
    for i, (seq, fr) in enumerate(want.infos):
        jpg = f"{tree}/2d_rect/cam0/{seq}/2d_rect_cam0_{seq}_{fr}.jpg"
        png = port._depth_path(port.depth_dir, seq, fr)
        got = fk.assemble_rgbd_plain(
            torch.from_numpy(native_io.decode_jpeg(jpg).copy()),
            torch.from_numpy(native_io.decode_png16(png)), image_size)
        assert np.array_equal(got.numpy(), want[i]["image"][0]), (seq, fr)


def coda_cfg(root: str) -> dict:
    return {"name": "coda", "root": root, "grid": 32, "map_range": 1.6,
            "horizon": 10}


@pytest.mark.parametrize("make", [
    lambda cfg: cd.CodaDataset(cfg, device="cuda"),
    lambda cfg: cd.CodaDataset(cfg),
    lambda cfg: build_dataset(cfg, "train", device="cuda"),
    lambda cfg: build_dataset(cfg, "train"),
    lambda cfg: native_io.DeviceFrameDecoder("cuda"),
], ids=["reader", "reader_default", "build_dataset", "build_dataset_default",
        "decoder"])
def test_card_reader_raises_without_a_card(tree, make, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make(coda_cfg(tree))


def test_process_mode_refuses_a_card_reader(tree):
    card_reader = SimpleNamespace(device=torch.device("cuda", 0))
    with pytest.raises(ValueError, match="loader_worker_mode=thread"):
        EpochLoader(card_reader, 2, worker_mode="process")
    # threads take it, and process mode takes the CPU reader
    EpochLoader(card_reader, 2, worker_mode="thread")
    cpu = build_dataset(coda_cfg(tree), "train", device="cpu")
    EpochLoader(cpu, 2, worker_mode="process").close()
    assert cpu.device == torch.device("cpu")


def test_only_frame_io_links_nvjpeg(monkeypatch):
    monkeypatch.setattr(_build, "nvcc", lambda: "/usr/local/cuda/bin/nvcc")
    names = _build.sources()
    assert "frame_io" in names and len(names) >= 4
    for name in names:
        cmd = _build.nvcc_command(name, Path("out.so"))
        assert cmd[0] == "/usr/local/cuda/bin/nvcc"
        assert str(_build.CSRC / f"{name}.cu") in cmd
        assert ("-lnvjpeg" in cmd) == (name == "frame_io"), (name, cmd)
        assert any(a.startswith("-rpath,") for a in cmd) == (
            name == "frame_io")
        # the library's name is keyed on its source alone
        assert _build.library_path(name).name.startswith(f"{name}-")


def _refuse_library():
    raise AssertionError("the wrapper loaded the kernel's library")


def planes(H: int = 8, W: int = 8, ch: int = 4, cw: int = 4,
           dtype=torch.uint8):
    return (torch.zeros((H, W), dtype=dtype),
            torch.zeros((ch, cw), dtype=dtype),
            torch.zeros((ch, cw), dtype=dtype))


@pytest.mark.parametrize("planes_, depth, match", [
    (planes(dtype=torch.float32), None, "uint8"),
    (planes(ch=3), None, "4:2:0"),
    (planes(ch=8, cw=4, W=9), None, "4:2:0"),
    (planes(), torch.zeros((8, 8), dtype=torch.int32), "uint16"),
    (planes(), torch.zeros((8, 9), dtype=torch.uint16), "uint16"),
    (planes(), None, "CUDA tensors"),
    (planes(), torch.zeros((8, 8), dtype=torch.uint16), "CUDA tensors"),
], ids=["f32_planes", "chroma_rows", "chroma_width", "int32_depth",
        "depth_shape", "cpu", "cpu_depth"])
def test_wrapper_refuses_before_launch(planes_, depth, match, monkeypatch):
    monkeypatch.setattr(fk, "_lib", _refuse_library)
    before = fk.assemble_rgbd_cuda.launches
    with pytest.raises(ValueError, match=match):
        fk.assemble_rgbd_cuda(planes_, depth, (4, 4))
    with pytest.raises(ValueError, match="CUDA device"):
        fk.JpegDecoder(torch.device("cpu"))
    assert fk.assemble_rgbd_cuda.launches == before


def jpeg_bytes(rgb: np.ndarray, subsampling: int, quality: int) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, "JPEG", quality=quality,
                              subsampling=subsampling)
    return buf.getvalue()


@pytest.mark.parametrize("sub, factors", [(2, (2, 2)), (1, (2, 1)),
                                          (0, (1, 1))],
                         ids=["420", "422", "444"])
def test_ycc_to_rgb_plain_is_libjpegs(sub, factors):
    """The planes of a JPEG whose colour is constant over 32x32 blocks
    decode exactly (quality 100, DC only), so they are known: each block's
    values, read where PIL's upsampled YCbCr is flat. From them
    ``ycc_to_rgb_plain`` gives PIL's RGB to the bit, the fancy
    upsampling's blends at the block edges and the image's edges
    included."""
    sh, sv = factors
    H, W, R = 96, 128, 32
    rng = np.random.default_rng(sub)
    img = np.kron(rng.integers(0, 256, (H // R, W // R, 3)),
                  np.ones((R, R, 1), np.int64)).astype(np.uint8)
    data = jpeg_bytes(img, sub, 100)
    rgb = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    im = Image.open(io.BytesIO(data))
    im.draft("YCbCr", im.size)
    ycc = np.asarray(im)
    assert im.mode == "YCbCr" and ycc.shape == (H, W, 3)
    chroma = []
    for k in (1, 2):
        c = np.zeros((H // sv, W // sh), np.uint8)
        for i in range(H // R):
            for j in range(W // R):
                c[i * R // sv:(i + 1) * R // sv,
                  j * R // sh:(j + 1) * R // sh] = ycc[i * R + R // 2,
                                                      j * R + R // 2, k]
        chroma.append(torch.from_numpy(c))
    got = fk.ycc_to_rgb_plain(torch.from_numpy(ycc[..., 0].copy()), *chroma)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (H, W, 3)
    assert np.array_equal(got.numpy(), rgb), int((got.numpy() != rgb).sum())


def test_ycc_conversion_is_libjpegs_on_noise():
    """On a noisy frame at quality 90 (4:4:4, so no upsampling), PIL's
    YCbCr planes through ``ycc_to_rgb_plain`` are PIL's RGB to the bit:
    the fixed-point conversion over every value a frame holds."""
    rgb, _ = frame(64, 80)
    data = jpeg_bytes(rgb, 0, 90)
    im = Image.open(io.BytesIO(data))
    im.draft("YCbCr", im.size)
    ycc = torch.from_numpy(np.asarray(im).copy())
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    got = fk.ycc_to_rgb_plain(ycc[..., 0].contiguous(),
                              ycc[..., 1].contiguous(),
                              ycc[..., 2].contiguous())
    assert np.array_equal(got.numpy(), want)
