"""Device meshes: where the trial, sample and data axes are split.

Counterpart of ``flexynesis_tpu/parallel/mesh.py``. JAX expresses a sharding
as a ``Mesh`` over devices and a ``NamedSharding``, and XLA partitions one
program. PyTorch has no such partitioner for this code, so the port splits
the work where the JAX package's semantics allow it:

* ``trial``: a shard of a stacked trial round runs on its device with no
  collective (``parallel/trials.py``); the draws are made at the round's full
  trial count and sliced, and early stopping is decided over all shards;
* ``data`` for attribution: each device attributes a contiguous slice of a
  batch's rows and the |attr| sums are added (``interpret/attribution.py``);
* ``data`` for a single-model fit: one process per device over a
  ``torch.distributed`` group (``parallel/distributed.py``,
  ``train/trainer.py``).

A ``Mesh`` is an array of ``torch.device``s with axis names. ``get_mesh`` and
``auto_trial_mesh`` build over the local CUDA devices by default, as JAX's
build over ``jax.devices()`` / ``jax.local_devices()``, and raise or return
None without a card. Both also take an explicit device list, repeats allowed:
``[torch.device("cpu")] * 8`` stands in for the JAX tests' 8 virtual CPU
devices, and ``[cuda:0, cuda:0]`` drives the sharded code on one card.
"""

from __future__ import annotations

import contextlib
import copy
import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.collectives import split_rows


def _canonical(device) -> torch.device:
    """``device`` as a torch.device, a CUDA device with its index."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def local_devices(device_type: str = "cuda") -> List[torch.device]:
    """This process's devices of a type: the local CUDA devices (none without
    a card), or the one CPU."""
    if device_type == "cpu":
        return [torch.device("cpu")]
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class Mesh:
    """Devices arranged on named axes: ``devices`` is an object array of
    ``torch.device``s whose shape gives each axis its size."""

    def __init__(self, devices, axis_names: Sequence[str]):
        flat = [_canonical(d) for d in np.asarray(devices, dtype=object).reshape(-1)]
        arr = np.empty(len(flat), dtype=object)
        arr[:] = flat
        self.devices = arr.reshape(np.shape(devices))
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim} mesh axes for names {self.axis_names}")
        self.shape = dict(zip(self.axis_names, self.devices.shape))
        self.size = int(self.devices.size)

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along ``axis``, the other axes at their first index."""
        i = self.axis_names.index(axis)
        index = [0] * self.devices.ndim
        index[i] = slice(None)
        return list(self.devices[tuple(index)])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.reshape(-1)]})"


def _group_devices() -> Optional[List[torch.device]]:
    """One device per rank of the live process group (each process drives
    one), or None without a group."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return None
    if dist.get_backend() == "nccl":
        n = torch.cuda.device_count()
        return [torch.device("cuda", r % n) for r in range(dist.get_world_size())]
    return [torch.device("cpu")] * dist.get_world_size()


def get_mesh(axes: Sequence[Tuple[str, int]] = (("data", -1),),
             devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over ``devices``; by default over the global devices, as JAX's
    ``jax.devices()``: one per rank of the live process group, else the local
    CUDA devices (a RuntimeError without a card). ``axes`` is a sequence of
    (name, size); one size may be -1 (inferred)."""
    if devices is None:
        devices = _group_devices() or local_devices()
    devices = [_canonical(d) for d in devices]
    if not devices:
        raise RuntimeError("get_mesh: no CUDA device is available; pass devices= "
                           "(e.g. [torch.device('cpu')] * 8) to build a mesh on the CPU")
    sizes = [int(s) for _, s in axes]
    if -1 in sizes:
        known = math.prod(s for s in sizes if s != -1)
        sizes[sizes.index(-1)] = len(devices) // known
    n = math.prod(sizes)
    if n < 1 or n > len(devices):
        raise ValueError(f"a mesh of shape {tuple(sizes)} needs {n} devices; "
                         f"{len(devices)} are given")
    arr = np.empty(n, dtype=object)
    arr[:] = devices[:n]
    return Mesh(arr.reshape(sizes), tuple(name for name, _ in axes))


def auto_trial_mesh(n_trials: int, devices: Optional[Sequence] = None) -> Optional[Mesh]:
    """A ``trial`` mesh over the local devices (or ``devices``) when
    ``n_trials`` splits evenly over more than one; None otherwise (one
    device, or an uneven split). The shared policy of the HPO and
    fine-tuning rounds, as in JAX."""
    devices = local_devices() if devices is None else [_canonical(d) for d in devices]
    n_dev = len(devices)
    if n_dev > 1 and n_trials % n_dev == 0:
        arr = np.empty(n_dev, dtype=object)
        arr[:] = devices
        return Mesh(arr, ("trial",))
    return None


class NamedSharding(NamedTuple):
    """The leading axis split over mesh axis ``axis``, or replicated (None)."""

    mesh: Mesh
    axis: Optional[str]

    def devices(self) -> List[torch.device]:
        if self.axis is None:
            return list(self.mesh.devices.reshape(-1))
        return self.mesh.axis_devices(self.axis)


def trial_sharding(mesh: Mesh) -> NamedSharding:
    """Leading-axis sharding for stacked per-trial tensors."""
    return NamedSharding(mesh, "trial")


def data_sharding(mesh: Mesh) -> NamedSharding:
    """Leading-axis (batch) sharding."""
    return NamedSharding(mesh, "data")


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, None)


def _map(tree, fn):
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return tree


def shard_leading_axis(tree, sharding: NamedSharding) -> list:
    """One copy of ``tree`` per device of the sharding: with an axis, device
    i holds slice i of every tensor's leading axis (contiguous, as
    ``split_rows`` cuts it); replicated, every device holds the whole tree."""
    devices = sharding.devices()
    if sharding.axis is None:
        return [_map(tree, lambda t, d=d: t.to(d)) for d in devices]
    out = []
    for i, d in enumerate(devices):
        def take(t, i=i, d=d):
            return t[split_rows(t.shape[0], len(devices))[i]].to(d)
        out.append(_map(tree, take))
    return out


def device_context(device):
    """``torch.cuda.device(device)`` for a CUDA device, else nothing: the
    kernels launch on the current device's stream."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def to_device(tree, device):
    """Every tensor of ``tree`` (dicts, lists, tuples) on ``device``."""
    return _map(tree, lambda t: t.to(device))


def replica(model, device):
    """``model`` itself where it lies on ``device``, else a copy there: its
    module deep-copied and moved, and every tensor it holds (the GNN's
    operator, the triplet model's group table) moved."""
    device = _canonical(device)
    if _canonical(model.device) == device:
        return model
    twin = copy.copy(model)
    twin.__dict__ = {k: to_device(v, device) for k, v in model.__dict__.items()
                     if k != "module"}
    twin.module = copy.deepcopy(model.module).to(device)
    twin.device = device
    return twin
