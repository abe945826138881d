"""Build the port's CUDA sources with nvcc and load them with ctypes.

Every ``csrc/*.cu`` compiles at first use into a shared library with a plain
C interface (``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
-Xcompiler -fPIC``) under ``build/kernels/`` at the root of the checkout.
The library's file name carries a hash of its source, so an edited source
is rebuilt and a stale library is never loaded. Sources come only from the
package's ``csrc/`` directory.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def sources() -> list[str]:
    """Names (file stems) of every CUDA source of the package."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names: list[str] | None = None) -> dict[str, dict]:
    """Compile the named sources (default: all) that are not built yet, one
    nvcc process each, all started together. Returns per source the
    seconds its build took (0.0 when already built) and nvcc's ``-Xptxas
    -v`` report. Raises with nvcc's output when a build fails."""
    names = sources() if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started, report = {}, {}
    for name in names:
        out = library_path(name)
        if out.exists():
            report[name] = {"seconds": 0.0, "log": ""}
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        started[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in started.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return report


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, building it if needed."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))
