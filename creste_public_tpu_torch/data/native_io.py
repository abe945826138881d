"""Frame decoding of the CODa reader: JPEG images, 16-bit PNG depth, raw
float32 bins.

The functions of ``creste_public_tpu/data/native_io.py``, backed by PIL
and numpy: the reader's CPU path and the plain decode. The JAX package
binds a C library (``native/creste_io.cpp``, libjpeg and libpng) and
falls back to PIL where it is not built; these functions equal the JAX
reader's PIL branch (``coda_dataset.py:215-217, 231``) exactly. PIL's
decoders release the GIL, so ``ParallelAssembler``'s threads decode in
parallel too.

``DeviceFrameDecoder`` is the card's counterpart of the C library's fused
``assemble_rgbd``: nvJPEG decodes the JPEG on the card and the kernel of
``ops/frame_kernel.py`` assembles and resizes the RGBD sample there (the
card's machine has no libjpeg; nvJPEG decodes no PNG, so the 16-bit depth
PNG is decoded here by PIL and uploaded).
"""
from __future__ import annotations

import queue
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from PIL import Image


def jpeg_shape(path: str) -> tuple[int, int, int]:
    """(height, width, channels) of a JPEG, from its header."""
    with Image.open(path) as im:
        return im.height, im.width, len(im.getbands())


def decode_jpeg(path: str) -> np.ndarray:
    """[H, W, 3] uint8 RGB."""
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def png16_shape(path: str) -> tuple[int, int]:
    with Image.open(path) as im:
        return im.height, im.width


def decode_png16(path: str) -> np.ndarray:
    """[H, W] uint16 (depth in mm)."""
    with Image.open(path) as im:
        return np.asarray(im).astype(np.uint16)


def assemble_rgbd(jpeg_path: str, png_path: str | None) -> np.ndarray:
    """[H, W, 4] float32: RGB / 255 and the depth-mm channel (0 without a
    depth file)."""
    rgb = decode_jpeg(jpeg_path)
    out = np.empty(rgb.shape[:2] + (4,), np.float32)
    out[..., :3] = rgb.astype(np.float32) / 255.0
    out[..., 3] = decode_png16(png_path) if png_path else 0.0
    return out


def read_bin(path: str, max_floats: int = 131072 * 5) -> np.ndarray:
    """The first ``max_floats`` float32 values of a raw binary file."""
    return np.fromfile(path, np.float32, count=max_floats)


class ParallelAssembler:
    """Thread-pool RGBD assembly: N threads decode N samples
    concurrently."""

    def __init__(self, num_threads: int = 8):
        self.pool = ThreadPoolExecutor(max_workers=num_threads)

    def assemble_batch(
        self, pairs: list[tuple[str, str | None]]
    ) -> np.ndarray:
        """[(jpeg, png), ...] -> [B, H, W, 4] float32."""
        results = list(self.pool.map(lambda p: assemble_rgbd(*p), pairs))
        return np.stack(results)

    def close(self):
        self.pool.shutdown()


class _DecodeContext:
    """What one decoding thread holds: an nvJPEG state, a stream, and
    pinned staging for the depth map's upload and the sample's read-back
    (grown to the largest frame seen)."""

    def __init__(self, device: torch.device):
        from creste_public_tpu_torch.ops import frame_kernel

        self.jpeg = frame_kernel.JpegDecoder(device)
        self.stream = torch.cuda.Stream(device)
        self.staging: dict[str, torch.Tensor] = {}

    def pinned(self, name: str, shape, dtype) -> torch.Tensor:
        n = int(np.prod(shape))
        buf = self.staging.get(name)
        if buf is None or buf.numel() < n:
            buf = torch.empty(n, dtype=dtype, pin_memory=True)
            self.staging[name] = buf
        return buf[:n].view(shape)


class DeviceFrameDecoder:
    """RGBD samples decoded on a card: ``assemble(jpeg_path, png_path,
    size)`` gives the [h, w, 4] f32 numpy array the reader's PIL path gives
    (RGB / 255 resized BILINEAR, depth in mm resized NEAREST), with the
    JPEG decoded by nvJPEG into its planes and libjpeg's conversion to RGB,
    the assembly and the resize in one launch of
    ``frame_kernel.assemble_rgbd_cuda`` (its ``launches`` count them); its
    RGB differs from PIL's only by the two decoders' inverse DCTs.

    Threads may call ``assemble`` concurrently: each call takes a free
    context (an nvJPEG state, a stream, pinned staging), making one when
    none is free, and gives it back. The decoder lives in one process and
    does not pickle."""

    def __init__(self, device: str | torch.device = "cuda"):
        from creste_public_tpu_torch.ops import frame_kernel
        from creste_public_tpu_torch.utils.device import resolve_device

        self.device = frame_kernel.cuda_device(resolve_device(device))
        # contexts live as long as the decoder (the reader's, the process)
        self._free: queue.SimpleQueue = queue.SimpleQueue()

    def __getstate__(self):
        raise TypeError("a DeviceFrameDecoder holds nvJPEG states and CUDA "
                        "streams of its process and does not pickle")

    def assemble(self, jpeg_path: str, png_path: str | None,
                 size=None) -> np.ndarray:
        from creste_public_tpu_torch.ops import frame_kernel

        data = np.fromfile(jpeg_path, np.uint8)
        depth = decode_png16(png_path) if png_path else None
        try:
            ctx = self._free.get_nowait()
        except queue.Empty:
            ctx = _DecodeContext(self.device)
        try:
            with torch.cuda.device(self.device), torch.cuda.stream(
                    ctx.stream):
                planes = ctx.jpeg.decode(data)
                d = None
                if depth is not None:
                    up = ctx.pinned("depth", depth.shape, torch.uint16)
                    up.numpy()[...] = depth
                    d = up.to(self.device, non_blocking=True)
                out = frame_kernel.assemble_rgbd_cuda(planes, d, size)
                host = ctx.pinned("out", out.shape, torch.float32)
                host.copy_(out, non_blocking=True)
                ctx.stream.synchronize()
                return host.numpy().copy()
        finally:
            self._free.put(ctx)
