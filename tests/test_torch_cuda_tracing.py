"""The port's spans on the CUDA card (``flexynesis_torch/utils/profiling.py``);
they skip where there is none.

Under a CUDA-only ``torch.profiler`` (the benchmark's traced stretch), spans
are recorded, and they add no device activity: the profiler's CUDA-typed
events of a stacked trial round are the same with the recorder on and
forced off. ``trace()`` on the card writes the idle seconds by span.

This file imports neither JAX nor the JAX package:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_tracing.py -q``."""

import json
import types
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from flexynesis_torch.data.dataset import MultiOmicDataset
from flexynesis_torch.models.direct_pred import DirectPred
from flexynesis_torch.train.hpo import HyperparameterTuning
from flexynesis_torch.utils import profiling


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    profiling.clear()
    yield torch.device("cuda")
    profiling.clear()


def _dataset(n=200):
    rng = np.random.default_rng(0)
    y = np.arange(n) % 3
    dat = {"gex": (rng.normal(size=(n, 64)) + y[:, None]).astype(np.float32),
           "cnv": rng.normal(size=(n, 32)).astype(np.float32)}
    return MultiOmicDataset(
        dat=dat, ann={"subtype": y.astype(np.float32)}, variable_types={"subtype": "categorical"},
        features={k: [f"{k}{j}" for j in range(v.shape[1])] for k, v in dat.items()},
        samples=[f"s{i}" for i in range(n)],
        label_mappings={"subtype": {c: f"c{c}" for c in range(3)}})


def _round(device):
    """One same-architecture round of 4 trials, 2 epochs of 10 steps."""
    tuner = HyperparameterTuning(_dataset(), DirectPred, "DirectPred", ["subtype"], n_iter=4,
                                 batch_ask=4, early_stop_patience=-1, device=device)
    group = [{"latent_dim": 16, "hidden_dim_factor": 0.3, "lr": lr, "supervisor_hidden_dim": 8,
              "epochs": 2, "batch_size": 16} for lr in (1e-4, 1e-3, 3e-3, 1e-2)]
    return lambda: tuner._run_parallel_group(group)


def _device_event_names(fn):
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return Counter(e.name() for e in prof.profiler.kineto_results.events()
                   if str(e.device_type()).split(".")[-1] == "CUDA")


@pytest.mark.cuda
def test_spans_record_under_a_cuda_profiler_and_add_no_device_event(card, monkeypatch):
    run = _round(card)
    run()   # warm
    torch.cuda.synchronize()
    profiling.clear()
    on = _device_event_names(run)
    spans, counters = profiling.recorded()
    assert counters["engine.steps"] == 2 * (160 // 16) and counters["tuner.rounds"] == 1
    assert {"tuner.round", "engine.step", "optim.update", "host.wait"} <= {s[0] for s in spans}
    profiling.clear()
    monkeypatch.setattr(profiling, "_profiler", types.SimpleNamespace(_is_profiler_enabled=False))
    off = _device_event_names(run)
    assert profiling.recorded() == ([], {})
    assert on == off and sum(on.values()) > 0


@pytest.mark.cuda
def test_trace_on_the_card_writes_idle_seconds_by_span(card, tmp_path):
    run = _round(card)
    run()
    with profiling.trace(str(tmp_path / "tr"), card):
        run()
    summary = json.loads((tmp_path / "tr" / "spans.json").read_text())
    idle = summary["idle_s"]
    assert idle and all(v >= 0 for v in idle.values())
    assert set(idle) <= set(summary["spans"]) | {"host"}
    assert summary["counters"]["engine.steps"] == 20
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())["traceEvents"]
    steps = [e for e in events if e.get("name") == "engine.step"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    assert len(steps) == 20 and kernels
    # the span track lies over the kernels' stretch of the timeline
    assert steps[0]["ts"] < max(k["ts"] for k in kernels)
    assert steps[-1]["ts"] + steps[-1]["dur"] > min(k["ts"] for k in kernels)
