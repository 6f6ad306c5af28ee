"""Device choice for the port's entry points.

``auto`` and ``cuda`` mean the CUDA card and raise when there is none: the
port never carries on on the CPU unless the caller asks for ``cpu``. ``tpu``
and ``mps`` are not targets of this package and raise.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch

DEVICE_CHOICES = ("auto", "tpu", "cuda", "mps", "cpu")


def resolve_device(preference="auto") -> torch.device:
    if isinstance(preference, torch.device):
        preference = str(preference)
    if preference in ("auto", "cuda") or preference.startswith("cuda:"):
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"--device {preference}: no CUDA device is available. "
                "flexynesis_torch runs on the card; pass --device cpu to run "
                "on the CPU instead."
            )
        return torch.device("cuda" if preference == "auto" else preference)
    if preference == "cpu":
        return torch.device("cpu")
    raise ValueError(
        f"device '{preference}' is not supported by flexynesis_torch "
        "(use cuda or cpu; flexynesis_tpu serves TPUs)"
    )


@contextlib.contextmanager
def host_threads(n: Optional[int], device):
    """torch's CPU threads set to ``n`` while the block runs, where its work
    runs on the CPU (the CLI's ``--threads``, the baselines' ``n_jobs``), and
    restored after; on the card, or for ``n`` None, nothing changes."""
    if n is None or resolve_device(device).type != "cpu":
        yield
        return
    before = torch.get_num_threads()
    torch.set_num_threads(int(n))
    try:
        yield
    finally:
        torch.set_num_threads(before)


@contextlib.contextmanager
def full_f32():
    """Float32 products in full precision while the block runs (TF32 off on
    the card, as the JAX package's products run on the CPU), restored after."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def get_optimal_device(device_preference: Optional[str] = None):
    """(torch.device, its type) for a preference: ``resolve_device``'s rule,
    the card for None or "auto" (raising without one), never a silent CPU."""
    dev = resolve_device(device_preference or "auto")
    print(f"[INFO] Using device: {dev}")
    return dev, dev.type


def create_device_from_string(device_str: Optional[str]) -> torch.device:
    return get_optimal_device(device_str)[0]


def to_device_safe(array, device) -> torch.Tensor:
    """A tensor on ``device``; float64 arrays become float32."""
    arr = np.asarray(array)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    return torch.as_tensor(arr, device=resolve_device(device))


def get_device_memory_info(device=None) -> dict:
    """Bytes in use / limit for a device, where the backend reports them."""
    dev = resolve_device(device or "auto")
    stats = {}
    if dev.type == "cuda":
        free, total = torch.cuda.mem_get_info(dev)
        stats = {"bytes_in_use": torch.cuda.memory_allocated(dev), "bytes_limit": total,
                 "peak_bytes_in_use": torch.cuda.max_memory_allocated(dev)}
    return {"device": str(dev), "platform": dev.type,
            "bytes_in_use": stats.get("bytes_in_use"), "bytes_limit": stats.get("bytes_limit"),
            "peak_bytes_in_use": stats.get("peak_bytes_in_use")}
