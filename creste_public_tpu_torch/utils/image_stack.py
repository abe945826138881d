"""What the machine offers for reading and writing images.

The JAX package's CODa reader and validation images decode and write JPEG
and PNG through ``native/creste_io.cpp`` (libjpeg, libpng), PIL or
matplotlib. ``probe()`` reports which of these (and NVIDIA's nvJPEG under
the CUDA toolkit) a machine has, so that the port's reader can be planned
on the machine it runs on:

    python -m creste_public_tpu_torch.utils.image_stack

prints one JSON object.
"""
from __future__ import annotations

import glob
import importlib.util
import json
import os
import sysconfig

_INCLUDE_DIRS = ("/usr/include", "/usr/local/include",
                 "/usr/include/x86_64-linux-gnu")


def _header(name: str, dirs) -> str | None:
    for d in dirs:
        path = os.path.join(d, name)
        if os.path.isfile(path):
            return path
    return None


def probe() -> dict:
    """{module or file: version, path, or None where absent}."""
    out: dict = {}
    for mod in ("PIL", "matplotlib", "cv2", "imageio", "torchvision",
                "nvidia.nvjpeg"):
        try:
            spec = importlib.util.find_spec(mod)
        except ModuleNotFoundError:
            spec = None
        if spec is None:
            out[mod] = None
            continue
        try:
            m = importlib.import_module(mod)
            out[mod] = str(getattr(m, "__version__", "present"))
        except Exception as e:  # noqa: BLE001 — reported, not raised
            out[mod] = f"import failed: {type(e).__name__}: {e}"
    dirs = [*_INCLUDE_DIRS, sysconfig.get_paths()["include"]]
    out["jpeglib.h"] = _header("jpeglib.h", dirs)
    out["png.h"] = _header("png.h", dirs)
    cuda = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    out["nvjpeg.h"] = _header("nvjpeg.h", [os.path.join(cuda, "include"),
                                           *_INCLUDE_DIRS])
    libs = sorted({os.path.basename(p) for pat in (
        os.path.join(cuda, "lib64", "libnvjpeg*"),
        os.path.join(cuda, "targets", "*", "lib", "libnvjpeg*"))
        for p in glob.glob(pat)})
    out["libnvjpeg"] = libs or None
    sys_libs = sorted({os.path.basename(p) for pat in (
        "/usr/lib/x86_64-linux-gnu/libjpeg.so*",
        "/usr/lib/x86_64-linux-gnu/libpng*.so*", "/usr/lib64/libjpeg.so*",
        "/usr/lib64/libpng*.so*") for p in glob.glob(pat)})
    out["libjpeg/libpng"] = sys_libs or None
    return out


if __name__ == "__main__":
    print(json.dumps(probe(), indent=1))
