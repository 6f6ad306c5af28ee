"""Phase timing and a device trace for ``--profile``.

Counterpart of ``flexynesis_tpu/utils/profiling.py``:

* ``PhaseTimer`` records each CLI phase's host-clock seconds and the change
  of ``torch.cuda.memory_allocated`` on the CLI's device across it (0 on the
  CPU), prints them as a ``[PROFILE]`` table and writes them to JSON, with
  the JAX package's keys. On a CUDA device it synchronises at both ends of a
  phase, so a phase's seconds hold the device work it queued.
* ``trace`` runs ``torch.profiler`` (CPU and CUDA activities where the device
  is CUDA) around a block and writes a Chrome trace under ``logdir``.
"""

from __future__ import annotations

import json
import os
import time
from contextlib import contextmanager
from typing import Dict, Optional

import torch


class PhaseTimer:
    def __init__(self, enabled: bool = True, device=None):
        self.enabled = enabled
        self.device = torch.device(device or "cpu")
        self.phases: Dict[str, dict] = {}

    def _sync_mem(self) -> int:
        if self.device.type != "cuda":
            return 0
        torch.cuda.synchronize(self.device)
        return int(torch.cuda.memory_allocated(self.device))

    @contextmanager
    def phase(self, name: str):
        if not self.enabled:
            yield
            return
        mem0 = self._sync_mem()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            mem1 = self._sync_mem()
            self.phases[name] = {
                "seconds": round(time.perf_counter() - t0, 3),
                "device_bytes_delta": mem1 - mem0,
            }

    def report(self, path: Optional[str] = None) -> None:
        if not self.enabled or not self.phases:
            return
        total = sum(p["seconds"] for p in self.phases.values())
        print("\n[PROFILE] phase timings:")
        for name, p in self.phases.items():
            pct = 100.0 * p["seconds"] / total if total else 0.0
            print(
                f"[PROFILE]   {name:<28} {p['seconds']:>9.3f}s  ({pct:4.1f}%)"
                f"  mem +{p['device_bytes_delta'] / 1e6:.1f}MB"
            )
        print(f"[PROFILE]   {'total':<28} {total:>9.3f}s")
        if path:
            with open(path, "w") as fh:
                json.dump(self.phases, fh, indent=2)
            print(f"[PROFILE] wrote {path}")


@contextmanager
def trace(logdir: Optional[str], device=None):
    """A torch.profiler trace of the block, written as
    ``<logdir>/trace.json`` (Chrome trace format); nothing without ``logdir``."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.device(device or "cpu").type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"[PROFILE] device trace written to {path}")
