"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled at first
use into ``build/kernels/<name>-<hash>.so`` at the root of the checkout. The
hash covers the source, the headers under ``csrc/`` and the compiler flags, so
an edited source or header is rebuilt and an unchanged one is loaded as it is. A missing ``nvcc`` or a failed build
raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

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


def library_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, named by a hash of the source, of
    every header under ``csrc/`` (an edited shared header rebuilds every
    library) and of the compiler flags."""
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("**/*.cuh")):
        digest.update(header.relative_to(CSRC_DIR).as_posix().encode())
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a library of the same hash exists.

    The compiler's report (``-Xptxas -v``: registers, shared memory, spills)
    is kept beside the library as ``<library>.log``."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) for {name}.cu:\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
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
