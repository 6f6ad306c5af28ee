"""The device trace's reduction: busy time from the union of device
intervals, kernel time by name, idle gaps labelled by the innermost host
span; and the hooks put every original back."""

from __future__ import annotations

import types

import pytest

from portbench import trace


def test_device_summary_union_and_gaps():
    ns = 1e9
    events = [("k1", 1 * ns, 2 * ns), ("k2", 1.5 * ns, 3 * ns), ("k1", 5 * ns, 6 * ns)]
    spans = [("round", 0.0, 10.0), ("ask", 3.5, 4.5)]   # host seconds
    out = trace.device_summary(events, (0.0, 8 * ns), spans, offset_ns=0.0)
    assert out["busy_s"] == pytest.approx(3.0)
    assert out["window_s"] == pytest.approx(8.0)
    assert out["kernels"] == {"k1": pytest.approx(2.0), "k2": pytest.approx(1.5)}
    # gaps: [0, 1] round, [3, 5] ask (midpoint 4), [6, 8] round
    assert out["gaps"] == {"round": pytest.approx(3.0), "ask": pytest.approx(2.0)}


def test_kernel_seconds_and_top():
    kernels = {"fused_linear_bn_relu_train_split_kernel(float const*)": 2.0,
               "bn_relu_merge_kernel": 1.0, "gemm": 5.0}
    assert trace.kernel_seconds(kernels, ("train_split", "merge")) == 3.0
    assert trace.top(kernels, 2, width=20) == [["gemm", 5.0],
                                               ["fused_linear_bn_relu", 2.0]]


def test_hooks_restore_and_refuse_missing():
    mod = types.SimpleNamespace(f=lambda: 1)
    original = mod.f

    class C:
        def g(self):
            return 2

    h = trace.Hooks()
    h.wrap(mod, "f", lambda orig: (lambda: orig() + 10))
    h.wrap(C, "g", lambda orig: (lambda self: orig(self) + 10))
    assert mod.f() == 11 and C().g() == 12
    h.restore()
    assert mod.f is original and C().g() == 2
    with pytest.raises(AttributeError, match="gone from the program"):
        h.wrap(mod, "missing", lambda orig: orig)


def test_tracer_off_keeps_counters_only():
    t = trace.Tracer(enabled=False)
    with t.span("x"):
        t.counters["n"] += 1
    assert t.spans == [] and t.counters["n"] == 1
