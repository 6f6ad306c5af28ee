"""Phase timing, spans and counters, and a device trace for ``--profile``.

Counterpart of ``flexynesis_tpu/utils/profiling.py``:

* ``PhaseTimer`` records each CLI phase's host-clock seconds and the change
  of ``torch.cuda.memory_allocated`` on the CLI's device across it (0 on the
  CPU), prints them as a ``[PROFILE]`` table and writes them to JSON, with
  the JAX package's keys. On a CUDA device it synchronises at both ends of a
  phase, so a phase's seconds hold the device work it queued.
* ``trace`` runs ``torch.profiler`` (CPU and CUDA activities where the device
  is CUDA) around a block and writes a Chrome trace under ``logdir``, with
  the block's spans on a track of their own, and ``spans.json`` beside it.

The port's own spans and counters (the port's addition): ``span(name)``
times a stretch of host code and ``count(name, n)`` adds to a counter, in
one process-wide recorder that records exactly while a ``torch.profiler``
session is open (``torch.autograd.profiler._is_profiler_enabled``, the flag
torch keeps for fast Python checks), so the benchmark's traced stretch and
``--profile`` get them and every other run records nothing. A span records
``(name, parent, t0_ns, t1_ns)`` on ``time.perf_counter_ns``, ``parent``
being the index of the enclosing open span (-1 at the top), so a span's self
time is its duration less its children's. A span never synchronises:
``host_wait()`` is the span (``host.wait``, counted in ``host.waits``) that
the port puts around each call that blocks the host on the device. Off, a
call costs an attribute read and a branch and returns one shared no-op
object. Spans nest in the order the host opens them: the port records from
one thread. ``recorded()`` returns what was recorded and ``clear()`` empties
the recorder.
"""

from __future__ import annotations

import json
import os
import re
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, List, Optional

import torch
import torch.autograd.profiler as _profiler

# the recorder: spans as [name, parent, t0_ns, t1_ns] (t1_ns None while
# open), the indices of the open spans, innermost last, and the counters
_spans: List[list] = []
_open: List[int] = []
_counters: Dict[str, int] = {}


class _Off:
    """The span while no profiler records. Its ``__enter__`` and
    ``__exit__`` are a builtin that ignores its arguments and returns ""
    (falsy, so an exception passes through): a ``with`` then runs no Python
    frame, half the cost of Python-level methods."""

    __slots__ = ()
    __enter__ = "".format
    __exit__ = "".format


_OFF = _Off()


class _Span:
    __slots__ = ("name", "record", "index")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.index = len(_spans)
        self.record = [self.name, _open[-1] if _open else -1, 0, None]
        _spans.append(self.record)
        _open.append(self.index)
        self.record[2] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.record[3] = time.perf_counter_ns()
        if _open and _open[-1] == self.index:
            _open.pop()
        return False


def recording() -> bool:
    """Whether a torch profiler is open, so spans and counters record."""
    return _profiler._is_profiler_enabled


def span(name: str):
    """A context manager timing its block as span ``name`` while a profiler
    records; otherwise a no-op."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


def host_wait():
    """The span ``host.wait`` around a call that blocks the host on the
    device (a readback, a copy from pageable memory), counted in
    ``host.waits``."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    _counters["host.waits"] = _counters.get("host.waits", 0) + 1
    return _Span("host.wait")


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while a profiler records."""
    if _profiler._is_profiler_enabled:
        _counters[name] = _counters.get(name, 0) + n


def recorded():
    """``(spans, counters)``: every span as ``(name, parent, t0_ns, t1_ns)``
    in the order they opened (``t1_ns`` None while open), and a copy of the
    counters."""
    return [tuple(s) for s in _spans], dict(_counters)


def clear() -> None:
    """Empty the recorder."""
    _spans.clear()
    _open.clear()
    _counters.clear()


def summarise(spans) -> Dict[str, dict]:
    """Per span name: count, total seconds and self seconds (less the
    children's), over the closed spans of ``spans`` (``recorded()``'s)."""
    child = defaultdict(int)
    for _, parent, t0, t1 in spans:
        if parent >= 0 and t1 is not None:
            child[parent] += t1 - t0
    out: Dict[str, dict] = {}
    for i, (name, _, t0, t1) in enumerate(spans):
        if t1 is None:
            continue
        row = out.setdefault(name, {"count": 0, "total_s": 0.0, "self_s": 0.0})
        row["count"] += 1
        row["total_s"] += (t1 - t0) / 1e9
        row["self_s"] += (t1 - t0 - child[i]) / 1e9
    return out


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


# the operation right after a host stamp whose profiler event ties the
# recorder's clock to the profiler's
_MARK = "aten::zeros"


def _ns(event, what: str) -> float:
    for attr, scale in ((f"{what}_ns", 1.0), (f"{what}_us", 1e3)):
        fn = getattr(event, attr, None)
        if fn is not None:
            return float(fn()) * scale
    raise AttributeError(f"profiler event has no {what}")


def _is_cuda(event) -> bool:
    return str(event.device_type()).split(".")[-1] == "CUDA"


def _idle_by_span(events, window, spans) -> Dict[str, float]:
    """Seconds of ``window`` (start, end) outside every device interval of
    ``events``, each gap given to the innermost span holding its midpoint
    (``host`` outside every span). ``spans`` are nested and in start order,
    in the profiler's clock."""
    w0, w1 = window
    busy: List[list] = []
    for s, e in sorted((max(s, w0), min(e, w1)) for s, e in events if e > w0 and s < w1):
        if busy and s <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], e)
        else:
            busy.append([s, e])
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    out: Dict[str, float] = defaultdict(float)
    stack: List[tuple] = []
    j = 0
    for gs, ge in zip(edges[0::2], edges[1::2]):
        if ge <= gs:
            continue
        mid = 0.5 * (gs + ge)
        while j < len(spans) and spans[j][2] <= mid:
            while stack and stack[-1][3] <= spans[j][2]:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][3] < mid:
            stack.pop()
        out[stack[-1][0] if stack else "host"] += (ge - gs) / 1e9
    return dict(out)


def _write_spans(logdir: str, prof, t_mark: int, window: tuple, spans: list, counters: dict,
                 cuda: bool) -> None:
    """The block's spans as complete events of their own track in
    ``trace.json``, and ``spans.json``: per name count, total and self
    seconds, the counters and, on CUDA, the idle seconds by span."""
    events = list(prof.profiler.kineto_results.events())
    marks = [_ns(e, "start") for e in events if e.name() == _MARK and not _is_cuda(e)]
    offset = min(marks) - t_mark   # profiler clock minus perf_counter, ns
    path = os.path.join(logdir, "trace.json")
    with open(path) as fh:
        text = fh.read()
    base = re.search(r'"baseTimeNanoseconds":\s*(\d+)', text)
    base = int(base.group(1)) if base else 0
    pid, tid = os.getpid(), "flexynesis spans"
    track = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
              "args": {"name": tid}}]
    track += [{"ph": "X", "cat": "span", "name": name, "pid": pid, "tid": tid,
               "ts": (t0 + offset - base) / 1e3, "dur": (t1 - t0) / 1e3}
              for name, _, t0, t1 in spans if t1 is not None]
    head = '"traceEvents": ['
    at = text.index(head) + len(head)
    rest = text[at:].lstrip()
    joined = ",".join(json.dumps(e) for e in track) + ("" if rest.startswith("]") else ",")
    with open(path, "w") as fh:
        fh.write(text[:at] + joined + text[at:])
    summary = {"spans": summarise(spans), "counters": counters, "idle_s": None}
    if cuda:
        device = [(_ns(e, "start"), _ns(e, "start") + _ns(e, "duration"))
                  for e in events if _is_cuda(e)]
        moved = [(n, p, t0 + offset, t1 + offset) for n, p, t0, t1 in spans if t1 is not None]
        summary["idle_s"] = _idle_by_span(device, (window[0] + offset, window[1] + offset),
                                          moved)
    with open(os.path.join(logdir, "spans.json"), "w") as fh:
        json.dump(summary, fh, indent=2)


@contextmanager
def trace(logdir: Optional[str], device=None):
    """A torch.profiler trace of the block, written as
    ``<logdir>/trace.json`` (Chrome trace format) with the block's spans on
    the track ``flexynesis spans``, and ``<logdir>/spans.json``; nothing
    without ``logdir``."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    cuda = torch.device(device or "cpu").type == "cuda"
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        first = len(_spans)
        counters0 = dict(_counters)
        if cuda:
            torch.cuda.synchronize()
        t_mark = time.perf_counter_ns()
        torch.zeros(1)
        t0 = time.perf_counter_ns()
        yield
        if cuda:
            torch.cuda.synchronize()
        t1 = time.perf_counter_ns()
        spans = [(n, p - first if p >= first else -1, a, b)
                 for n, p, a, b in _spans[first:]]
        counters = {k: v - counters0.get(k, 0) for k, v in _counters.items()
                    if v != counters0.get(k, 0)}
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    _write_spans(logdir, prof, t_mark, (t0, t1), spans, counters, cuda)
    print(f"[PROFILE] device trace written to {path}")
