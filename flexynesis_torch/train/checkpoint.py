"""Checkpoints of training state, for a run that resumes after preemption.

Counterpart of ``flexynesis_tpu/train/checkpoint.py`` (``TrainCheckpointer``)
without orbax: a state is one safetensors file (``utils/safetensors_io.py``)
of named tensors plus a JSON metadata entry, written to a temporary file and
moved into place with ``os.replace``, so a killed writer never leaves half a
checkpoint. bfloat16 tensors (the trial engine's SR-bf16 parameters and
moments) are stored as their 16-bit patterns and restored bit for bit;
generator states (``torch.Generator.get_state()``, CUDA generators included)
are uint8 tensors like any other.

``TrainCheckpointer`` keeps ``max_to_keep`` steps of ``Trainer.fit``'s state
in a directory, ``step_<epoch>.safetensors``, one every ``every_n_epochs``
epochs. The round checkpoint of ``parallel/trials.py`` uses the same file
format through ``save_state`` and ``load_state``.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, Optional, Tuple

import torch

from ..utils.safetensors_io import load_file, save_file

_BF16 = "__bf16__"  # metadata key: the names stored as bfloat16 bit patterns
_META = "__state__"  # metadata key: the JSON of the state's plain values


def save_state(path: str, tensors: Dict[str, torch.Tensor], meta: dict) -> None:
    """Write ``tensors`` (any device; float32, bfloat16, integer or uint8) and
    the JSON-serialisable ``meta`` atomically to ``path``."""
    arrays, bf16 = {}, []
    for name, t in tensors.items():
        t = t.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            bf16.append(name)
            t = t.view(torch.int16)
        arrays[name] = t.numpy()
    tmp = path + ".tmp"
    save_file(arrays, tmp, metadata={_BF16: json.dumps(bf16), _META: json.dumps(meta)})
    os.replace(tmp, path)


def load_state(path: str) -> Tuple[Dict[str, torch.Tensor], dict]:
    """(tensors on the CPU, meta) of a file ``save_state`` wrote."""
    with open(path, "rb") as fh:
        n = int.from_bytes(fh.read(8), "little")
        header = json.loads(fh.read(n))
    info = header.get("__metadata__", {})
    bf16 = set(json.loads(info.get(_BF16, "[]")))
    tensors = {}
    for name, arr in load_file(path).items():
        t = torch.from_numpy(arr.copy())
        tensors[name] = t.view(torch.bfloat16) if name in bf16 else t
    return tensors, json.loads(info.get(_META, "{}"))


class TrainCheckpointer:
    """Steps of a ``Trainer.fit`` state in ``directory``: one every
    ``every_n_epochs`` epochs, the newest ``max_to_keep`` kept."""

    PATTERN = re.compile(r"step_(\d+)\.safetensors$")

    def __init__(self, directory: str, every_n_epochs: int = 10, max_to_keep: int = 2):
        self.directory = os.path.abspath(directory)
        self.every_n_epochs = max(int(every_n_epochs), 1)
        self.max_to_keep = max(int(max_to_keep), 1)
        os.makedirs(self.directory, exist_ok=True)

    def steps(self) -> list:
        found = (self.PATTERN.match(f) for f in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.safetensors")

    def maybe_save(self, epoch: int, tensors: Dict[str, torch.Tensor], meta: dict) -> None:
        if epoch % self.every_n_epochs == 0:
            self.save(epoch, tensors, meta)

    def save(self, epoch: int, tensors: Dict[str, torch.Tensor], meta: dict) -> None:
        save_state(self._path(epoch), tensors, dict(meta, epoch=int(epoch)))
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self._path(old))

    def restore(self) -> Optional[Tuple[Dict[str, torch.Tensor], dict]]:
        """(tensors, meta) of the latest step, or None without one."""
        steps = self.steps()
        return load_state(self._path(steps[-1])) if steps else None

    def close(self) -> None:
        """Wait for pending writes (orbax's ``wait_until_finished``). Every
        ``save`` here has finished and been moved into place when it returns,
        so nothing is pending."""
