"""Build the port's native sources and load them with ctypes.

Each ``csrc/<name>.cu`` is a CUDA source compiled with nvcc for sm_90a, and
each ``csrc/<name>.cpp`` a host source compiled with g++ (the CSV reader,
with ``native/Makefile``'s flags). Both expose a plain C interface and are
compiled at first use into ``build/kernels/<name>-<hash>.so`` at the root of
the checkout. The hash covers the source, the headers under ``csrc/`` and
the compiler flags, and for a host source the target that ``-march=native``
resolves to on this machine, so an edited source or header is rebuilt, a
library built for another CPU is never loaded, and an unchanged one is loaded
as it is. A missing compiler or a failed build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from ..utils.profiling import count, span

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

GXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-shared")
GXX_LIBS = ("-lpthread",)

_loaded: dict = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (neither on PATH nor at /usr/local/cuda/bin/nvcc); "
        "the port's CUDA kernels cannot be built"
    )


def gxx() -> str:
    found = shutil.which("g++")
    if found:
        return found
    raise RuntimeError("g++ not found on PATH; the port's CSV reader cannot be built")


def source(name: str) -> Path:
    """``csrc/<name>.cu`` if there is one, else ``csrc/<name>.cpp``."""
    cu = CSRC_DIR / f"{name}.cu"
    return cu if cu.exists() else CSRC_DIR / f"{name}.cpp"


@functools.cache
def native_target() -> bytes:
    """What ``-march=native`` enables on this machine, as g++ reports it."""
    proc = subprocess.run([gxx(), "-march=native", "-Q", "--help=target"],
                          capture_output=True)
    if proc.returncode != 0:
        raise RuntimeError("g++ -march=native -Q --help=target failed:\n"
                           + proc.stderr.decode(errors="replace"))
    return proc.stdout


def library_path(name: str) -> Path:
    """The library of ``csrc/<name>``, named by a hash of the source, of
    every header under ``csrc/`` (an edited shared header rebuilds every
    library), of the compiler flags and, for a host source, of the CPU
    target it is built for."""
    src = source(name)
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC_DIR.glob("**/*.cuh")):
        digest.update(header.relative_to(CSRC_DIR).as_posix().encode())
        digest.update(header.read_bytes())
    if src.suffix == ".cu":
        digest.update(" ".join(NVCC_FLAGS).encode())
    else:
        digest.update(" ".join(GXX_FLAGS + GXX_LIBS).encode())
        digest.update(native_target())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>`` unless a library of the same hash exists.

    The compiler's report (for CUDA, ``-Xptxas -v``: registers, shared
    memory, spills) is kept beside the library as ``<library>.log``."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    src = source(name)
    if src.suffix == ".cu":
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    else:
        cmd = [gxx(), *GXX_FLAGS, str(src), "-o", str(tmp), *GXX_LIBS]
    with span("kernels.build"):
        count("kernels.builds")
        proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"{Path(cmd[0]).name} failed ({proc.returncode}) for {src.name}:\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>``, built first if needed."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(str(build(name)))
    return _loaded[name]


_launchers: dict = {}


def launcher(name: str, symbol: str, argtypes):
    """The C launcher ``symbol`` of ``csrc/<name>.cu``, built at first use;
    it returns the launch's CUDA error code as an int."""
    if (name, symbol) not in _launchers:
        fn = getattr(load(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _launchers[name, symbol] = fn
    return _launchers[name, symbol]


def current_stream(device: torch.device) -> int:
    """The handle of ``device``'s current stream, on which the kernels
    launch; ``device`` must be the current device."""
    if device.index != torch.cuda.current_device():
        raise ValueError(
            f"tensors are on {device} but the current device is "
            f"cuda:{torch.cuda.current_device()}; call torch.cuda.set_device first"
        )
    return torch.cuda.current_stream(device).cuda_stream
