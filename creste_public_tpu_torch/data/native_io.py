"""Frame decoding of the CODa reader: JPEG images, 16-bit PNG depth, raw
float32 bins.

The functions of ``creste_public_tpu/data/native_io.py``, backed by PIL
and numpy. The JAX package binds a C library (``native/creste_io.cpp``,
libjpeg and libpng) and falls back to PIL where it is not built; the
card's machine has neither library's headers, so the port decodes with
PIL alone, and its results equal the JAX reader's PIL branch
(``coda_dataset.py:215-217, 231``) exactly. PIL's decoders release the
GIL, so ``ParallelAssembler``'s threads decode in parallel too.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
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
