"""Spans, counters and the device trace, taken from outside the program.

``Hooks`` replaces a function or method of the program with a wrapper for
the life of a run and puts the original back at the end; a hook point that
is gone raises at once, naming it, so a renamed function cannot silently
leave a metric empty. ``Tracer`` keeps host-clock spans (with a
``torch.cuda.synchronize`` at both ends where the caller asks, so a span
holds the device work it issued) and counters in memory. ``device_summary``
reduces a CUDA-only ``torch.profiler`` trace to busy time, kernel time by
name and idle gaps labelled by the innermost span the host was in.
"""

from __future__ import annotations

import contextlib
import time
from collections import Counter, defaultdict
from typing import Dict, List, Optional

_MISSING = object()


class Hooks:
    """Attribute replacements undone by ``restore``."""

    def __init__(self):
        self._saved = []

    def wrap(self, owner, name: str, make):
        """Replace ``owner.name`` by ``make(original)``."""
        if not hasattr(owner, name):
            raise AttributeError(f"hook point {getattr(owner, '__name__', owner)}.{name} "
                                 "is gone from the program")
        original = getattr(owner, name)
        saved = owner.__dict__.get(name, _MISSING) if isinstance(owner, type) else original
        self._saved.append((owner, name, saved))
        setattr(owner, name, make(original))
        return original

    def restore(self):
        for owner, name, saved in reversed(self._saved):
            if saved is _MISSING:
                delattr(owner, name)
            else:
                setattr(owner, name, saved)
        self._saved.clear()


class Tracer:
    """Spans (name, start, end) on the host clock and counters. With
    ``enabled`` False spans cost nothing and are not kept; counters always
    count (they carry the work the end-to-end metrics divide)."""

    def __init__(self, enabled: bool, sync=None):
        self.enabled = enabled
        self.sync = sync
        self.spans: List[tuple] = []
        self.counters: Counter = Counter()

    @contextlib.contextmanager
    def span(self, name: str, sync: bool = False):
        if not self.enabled:
            yield
            return
        if sync and self.sync is not None:
            self.sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync and self.sync is not None:
                self.sync()
            self.spans.append((name, t0, time.perf_counter()))


def _ns(event, what: str) -> float:
    for attr, scale in ((f"{what}_ns", 1.0), (f"{what}_us", 1e3)):
        fn = getattr(event, attr, None)
        if fn is not None:
            return float(fn()) * scale
    raise AttributeError(f"profiler event has no {what}")


def device_events(prof) -> List[tuple]:
    """(name, start_ns, end_ns) of every device activity in a finished
    ``torch.profiler.profile``."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        dev = ev.device_type()
        if str(dev).split(".")[-1] != "CUDA":
            continue
        start = _ns(ev, "start")
        out.append((ev.name(), start, start + _ns(ev, "duration")))
    return out


def merged(intervals) -> List[list]:
    out: List[list] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def device_summary(events: List[tuple], window_ns: tuple, spans: List[tuple],
                   offset_ns: float) -> dict:
    """Busy seconds, kernel seconds by name and idle gaps by host span.

    ``events`` (name, start, end) in the profiler's clock; ``window_ns`` the
    traced window in that clock; ``spans`` (name, t0, t1) on the host's
    perf_counter, which ``offset_ns`` (profiler clock minus perf_counter
    nanoseconds) maps onto the profiler's clock. A gap is labelled by the
    innermost span holding its midpoint, else ``host``."""
    w0, w1 = window_ns
    clipped = [(max(s, w0), min(e, w1)) for _, s, e in events if e > w0 and s < w1]
    busy = merged(clipped)
    busy_ns = sum(e - s for s, e in busy)
    by_name: Dict[str, float] = defaultdict(float)
    for name, s, e in events:
        by_name[name] += (e - s) / 1e9
    host = [(n, t0 * 1e9 + offset_ns, t1 * 1e9 + offset_ns) for n, t0, t1 in spans]
    gaps: Dict[str, float] = defaultdict(float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for gs, ge in zip(edges[0::2], edges[1::2]):
        if ge <= gs:
            continue
        mid = 0.5 * (gs + ge)
        inside = [(t1 - t0, n) for n, t0, t1 in host if t0 <= mid <= t1]
        gaps[min(inside)[1] if inside else "host"] += (ge - gs) / 1e9
    return {"busy_s": busy_ns / 1e9, "window_s": (w1 - w0) / 1e9,
            "kernels": dict(by_name), "gaps": dict(gaps)}


def top(table: Dict[str, float], n: int = 10, width: int = 120) -> List[list]:
    """The ``n`` largest entries, names cut to ``width`` characters."""
    return [[k[:width], v] for k, v in sorted(table.items(), key=lambda kv: -kv[1])[:n]]


def kernel_seconds(kernels: Dict[str, float], needles) -> float:
    """Device seconds of the kernels whose name holds one of ``needles``."""
    return sum(s for name, s in kernels.items() if any(k in name for k in needles))


class Profiled:
    """A CUDA-only ``torch.profiler`` window with the host spans of the same
    stretch: ``with Profiled(tracer) as p: ...`` then ``p.summary``."""

    def __init__(self, tracer: Tracer):
        self.tracer = tracer
        self.summary: Optional[dict] = None

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._torch = torch
        self._first_span = len(self.tracer.spans)
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize()
        # a marker kernel right after a host timestamp ties the two clocks
        self._t_mark = time.perf_counter()
        torch.zeros(1, device="cuda").add_(1.0)
        torch.cuda.synchronize()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        torch = self._torch
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        self.prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        events = sorted(device_events(self.prof), key=lambda e: e[1])
        if not events:
            raise RuntimeError("the profiler saw no device activity")
        offset = events[0][1] - self._t_mark * 1e9
        window = (self._t0 * 1e9 + offset, t1 * 1e9 + offset)
        self.summary = device_summary(events[2:], window, self.tracer.spans[self._first_span:],
                                      offset)
        return False
