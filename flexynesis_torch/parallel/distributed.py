"""Multi-process helpers.

Counterpart of ``flexynesis_tpu/parallel/distributed.py``. JAX wires its
processes with ``jax.distributed`` and XLA's collectives; the port wires them
with ``torch.distributed``: ``initialize`` creates the process group (NCCL
between cards, gloo on the CPU) from an explicit address, and
``partition_trials`` splits an HPO suggestion batch over the processes,
round-robin, so each trains its share on its own devices. A fit's data axis
(``train/trainer.py``) runs one process per device over this group.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist

from ..utils.device import resolve_device
from .mesh import local_devices


def _init_method(address: str) -> str:
    """``tcp://host:port`` or ``file:///path``; a bare ``host:port`` is TCP."""
    if address.startswith(("tcp://", "file://")):
        return address
    if "://" in address:
        raise ValueError(f"init method {address!r}: use tcp://host:port or file:///path")
    return f"tcp://{address}"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device="auto") -> dict:
    """Create the process group of ``num_processes`` processes, this one rank
    ``process_id``, rendezvousing at ``coordinator_address``
    (``tcp://host:port``, ``host:port`` or ``file:///path``): NCCL on the card
    (``device`` "auto" or "cuda"; each process takes local card ``rank %
    cards`` as its device), gloo on the CPU (``device="cpu"``). Without a
    process count it does nothing: one process, no group (JAX's
    auto-discovery of a TPU slice has no counterpart). A group of one process
    is created when asked for, so a fit's collectives can run on one card.
    Returns JAX's summary: {process_index, process_count, local_devices,
    global_devices}; under a group each process drives one device."""
    kind = resolve_device(device).type
    if num_processes is not None and not dist.is_initialized():
        if coordinator_address is None or process_id is None:
            raise ValueError("initialize: num_processes needs coordinator_address and "
                             "process_id")
        if kind == "cuda":
            torch.cuda.set_device(int(process_id) % torch.cuda.device_count())
        dist.init_process_group("nccl" if kind == "cuda" else "gloo",
                                init_method=_init_method(coordinator_address),
                                world_size=int(num_processes), rank=int(process_id))
    if dist.is_initialized():
        world = dist.get_world_size()
        return {"process_index": dist.get_rank(), "process_count": world,
                "local_devices": 1, "global_devices": world}
    n = len(local_devices(kind))
    return {"process_index": 0, "process_count": 1, "local_devices": n, "global_devices": n}


def shutdown() -> None:
    """Destroy the process group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def partition_trials(suggestions: List[dict], process_index: Optional[int] = None,
                     process_count: Optional[int] = None) -> List[dict]:
    """This process's share of an HPO suggestion batch, round-robin by rank:
    the shares are disjoint, their union is the whole batch in order, their
    sizes differ by at most one, and with fewer suggestions than processes
    the last processes get none. ``process_index`` and ``process_count``
    default to the live group's rank and size (0 and 1 without a group)."""
    live = dist.is_available() and dist.is_initialized()
    pi = (dist.get_rank() if live else 0) if process_index is None else process_index
    pc = (dist.get_world_size() if live else 1) if process_count is None else process_count
    if not 0 <= pi < pc:
        raise ValueError(f"process_index {pi} out of range for {pc} hosts")
    return [s for i, s in enumerate(suggestions) if i % pc == pi]
