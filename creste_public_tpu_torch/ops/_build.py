"""Build the port's CUDA sources with nvcc and load them with ctypes, and
build the libtorch serving host.

Every ``csrc/*.cu`` compiles at first use into a shared library with a plain
C interface (``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
-Xcompiler -fPIC``) under ``build/kernels/`` at the root of the checkout.
The library's file name carries a hash of its source, so an edited source
is rebuilt and a stale library is never loaded. Sources come only from the
package's ``csrc/`` directory. A source that calls a CUDA toolkit library
links it (``LINK_LIBS``: ``frame_io.cu`` links nvJPEG, with the toolkit's
library directory as its run path); the others link nothing more.

``build_host`` compiles the C++ registration of ``creste::msfcn_head``
(``csrc/msfcn_head_op.cpp``, with ``csrc/msfcn_chain.cu`` compiled in for
the card) into a library and the host (``csrc/serve_host.cpp``) linked to
it, against the installed torch's headers and libraries, under
``build/host/``; never load that library into a Python process (it
registers the operator that ``ops/reward_kernel.py`` registers).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
HOST_DIR = BUILD_DIR.parent / "host"
OP_SOURCE, HOST_SOURCE, KERNEL_SOURCE = (
    "msfcn_head_op.cpp", "serve_host.cpp", "msfcn_chain.cu")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LINK_LIBS = {"frame_io": ["-lnvjpeg"]}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def sources() -> list[str]:
    """Names (file stems) of every CUDA source of the package."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def nvcc_command(name: str, out: Path) -> list[str]:
    """The nvcc command that builds ``csrc/<name>.cu`` into ``out``."""
    libs = LINK_LIBS.get(name, [])
    if libs:
        libdir = cuda_home() / "lib64"
        libs = [f"-L{libdir}", *libs, "-Xlinker", f"-rpath,{libdir}"]
    return [nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu"),
            *libs]


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
        cmd = nvcc_command(name, tmp)
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


def cuda_home() -> Path:
    """The CUDA toolkit's root (nvcc's parent's parent)."""
    return Path(nvcc()).resolve().parent.parent


def _cxx_standard() -> str:
    """The C++ standard this torch's extension builder compiles with."""
    import inspect

    import torch.utils.cpp_extension as ext

    found = re.findall(r"-std=c\+\+(\d+)", inspect.getsource(ext))
    return f"-std=c++{max(found, key=int) if found else '17'}"


def host_commands(cuda: bool, work: Path, op_name: str, host_name: str
                  ) -> tuple[list[list[str]], list[list[str]]]:
    """(the compile commands, run together; the link commands, in order)
    of the op library ``work/op_name`` and the host ``work/host_name``."""
    import torch
    import torch.utils.cpp_extension as ext

    cxx = os.environ.get("CXX", "g++")
    incs = [f"-I{p}" for p in ext.include_paths()]
    libdir = ext.library_paths()[0]
    flags = [_cxx_standard(), "-O1", "-fPIC",
             f"-D_GLIBCXX_USE_CXX11_ABI={int(torch._C._GLIBCXX_USE_CXX11_ABI)}"]
    libs = [f"-L{libdir}", f"-Wl,-rpath,{libdir}", "-Wl,--no-as-needed",
            "-ltorch", "-ltorch_cpu", "-lc10"]
    objs = [str(work / "op.o")]
    if cuda:
        home = cuda_home()
        flags += ["-DCRESTE_WITH_CUDA", f"-I{home / 'include'}"]
        libs += ["-ltorch_cuda", "-lc10_cuda", f"-L{home / 'lib64'}",
                 "-lcudart_static", "-ldl", "-lrt", "-lpthread"]
        objs.append(str(work / "chain.o"))
    compile_ = [[cxx, *flags, *incs, "-c", str(CSRC / src), "-o",
                 str(work / obj)]
                for src, obj in ((OP_SOURCE, "op.o"), (HOST_SOURCE, "host.o"))]
    if cuda:  # the kernel as an object: NVCC_FLAGS' arch, standard, -O3
        compile_.append([nvcc(), *NVCC_FLAGS[:4], "-c", "-Xcompiler",
                         "-fPIC", "-o", str(work / "chain.o"),
                         str(CSRC / KERNEL_SOURCE)])
    link = [[cxx, "-shared", "-o", str(work / op_name), *objs,
             f"-Wl,-soname,{op_name}", *libs],
            [cxx, "-o", str(work / host_name), str(work / "host.o"),
             f"-L{work}", "-Wl,--no-as-needed", f"-l:{op_name}",
             "-Wl,-rpath,$ORIGIN", *libs]]
    return compile_, link


def host_paths(cuda: bool) -> tuple[Path, Path]:
    """(the op library, the host) of ``build_host(cuda)``: file names
    carrying a hash of the sources, the torch version, the variant and the
    commands."""
    import torch

    variant = "cuda" if cuda else "cpu"
    h = hashlib.sha256(f"{torch.__version__} {variant} {sys.version}"
                       .encode())
    for src in (OP_SOURCE, HOST_SOURCE) + ((KERNEL_SOURCE,) if cuda else ()):
        h.update((CSRC / src).read_bytes())
    h.update(repr(host_commands(cuda, Path("W"), "op", "host")).encode())
    tag = f"{variant}-{h.hexdigest()[:16]}"
    return (HOST_DIR / f"libcreste_ops-{tag}.so",
            HOST_DIR / f"creste_serve_host-{tag}")


def build_host(cuda: bool) -> dict:
    """Build the op library and the host for the card (``cuda``, nvcc for
    the kernel) or the CPU, unless built; the compiles run together. Returns
    their paths and the seconds the build took (0.0 when already built).
    Raises with the compilers' output when a step fails."""
    op_path, host_path = host_paths(cuda)
    if op_path.exists() and host_path.exists():
        return {"op_library": str(op_path), "host": str(host_path),
                "seconds": 0.0}
    HOST_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=HOST_DIR, prefix=".build-") as tmp:
        work = Path(tmp)
        compile_, link = host_commands(cuda, work, op_path.name,
                                       host_path.name)
        procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True))
                 for cmd in compile_]
        failed = []
        for cmd, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd)}\n{log}")
        if failed:
            raise RuntimeError("the host's build failed:\n" + "\n".join(failed))
        for cmd in link:
            r = subprocess.run(cmd, capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError(f"the host's link failed:\n{' '.join(cmd)}"
                                   f"\n{r.stdout}{r.stderr}")
        # the library first: the host finds it next to itself
        os.replace(work / op_path.name, op_path)
        os.replace(work / host_path.name, host_path)
    return {"op_library": str(op_path), "host": str(host_path),
            "seconds": time.perf_counter() - t0}
