"""The port's spans and counters (``flexynesis_torch/utils/profiling.py``)
and the benchmark's readers of them (``portbench/layer_metrics/``).

* The recorder records exactly while a ``torch.profiler`` session is open:
  its gate is ``torch.autograd.profiler._is_profiler_enabled``, so a torch
  that drops that flag fails here rather than leaving the metrics empty.
* Off, a span costs under 0.5 us; on, spans nest and a span's self time is
  its duration less its children's.
* A tiny tuning job, a same-architecture round and a marker pass under a
  CPU profiler count their steps, samples and host waits.
* ``trace()`` puts the spans into ``trace.json`` on the profiler's clock and
  writes ``spans.json``.
* Each reader of ``portbench/layer_metrics/`` gives the hand-computed value
  on a hand-made recorder and nothing on an empty one.

Every test starts and ends with an empty recorder: pytest-xdist runs several
test files in one process."""

import importlib.util
import json
import time
import timeit
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from flexynesis_torch.data.dataset import MultiOmicDataset
from flexynesis_torch.models.direct_pred import DirectPred
from flexynesis_torch.train.hpo import HyperparameterTuning
from flexynesis_torch.utils import profiling
from flexynesis_torch.utils.profiling import count, host_wait, recorded, span, summarise, trace

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def empty_recorder():
    profiling.clear()
    yield
    profiling.clear()


@pytest.fixture
def recording(monkeypatch):
    """The gate held open without a profiler (no profiler's own cost)."""
    monkeypatch.setattr(profiling, "_profiler", types.SimpleNamespace(_is_profiler_enabled=True))


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _named(spans, name):
    return [i for i, s in enumerate(spans) if s[0] == name]


def test_gate_is_the_torch_profilers_flag():
    assert profiling._profiler is torch.autograd.profiler
    assert torch.autograd.profiler._is_profiler_enabled is False
    with span("outside"):
        count("outside")
    with host_wait():
        pass
    assert recorded() == ([], {})
    with _cpu_profile():
        assert torch.autograd.profiler._is_profiler_enabled is True
        assert profiling.recording()
        with span("inside"):
            count("inside", 3)
    assert not profiling.recording()
    with span("after"):
        count("inside")
    spans, counters = recorded()
    assert [s[0] for s in spans] == ["inside"] and counters == {"inside": 3}
    assert spans[0][1] == -1 and spans[0][3] >= spans[0][2]


def test_span_off_costs_under_half_a_microsecond():
    def sites():
        with span("engine.step"):
            pass
    n = 20000
    per_call = min(timeit.repeat(sites, number=n, repeat=15)) / n
    assert per_call < 0.5e-6, f"{per_call * 1e9:.0f} ns a span"
    assert recorded() == ([], {})


def test_exceptions_pass_through_spans(recording):
    for make in (lambda: span("x"), lambda: profiling._OFF):
        with pytest.raises(ValueError):
            with make():
                raise ValueError("through")
    spans, _ = recorded()
    assert [s[0] for s in spans] == ["x"] and spans[0][3] is not None


def test_nesting_and_self_time(recording):
    with span("outer"):
        time.sleep(0.002)
        with span("inner"):
            time.sleep(0.003)
            with host_wait():
                time.sleep(0.001)
        with span("inner"):
            pass
    with span("second"):
        pass
    spans, counters = recorded()
    assert [(s[0], s[1]) for s in spans] == [
        ("outer", -1), ("inner", 0), ("host.wait", 1), ("inner", 0), ("second", -1)]
    assert counters == {"host.waits": 1}
    for name, parent, t0, t1 in spans:
        assert t1 >= t0
        if parent >= 0:
            assert spans[parent][2] <= t0 and t1 <= spans[parent][3]
    table = summarise(spans)
    dur = [(t1 - t0) / 1e9 for _, _, t0, t1 in spans]
    assert table["outer"]["count"] == 1 and table["inner"]["count"] == 2
    assert table["outer"]["total_s"] == pytest.approx(dur[0])
    assert table["outer"]["self_s"] == pytest.approx(dur[0] - dur[1] - dur[3])
    assert table["inner"]["self_s"] == pytest.approx(dur[1] - dur[2] + dur[3])
    assert table["host.wait"]["self_s"] == pytest.approx(dur[2])
    assert table["outer"]["self_s"] >= 0.0015 and table["inner"]["self_s"] >= 0.0025


def test_clear_empties_the_recorder(recording):
    with span("a"):
        count("n")
    profiling.clear()
    assert recorded() == ([], {})


def _dataset(n=60, n_classes=3, seed=0):
    rng = np.random.default_rng(seed)
    y = np.arange(n) % n_classes
    dat = {"gex": (rng.normal(size=(n, 12)) + y[:, None]).astype(np.float32),
           "cnv": rng.normal(size=(n, 8)).astype(np.float32)}
    return MultiOmicDataset(
        dat=dat, ann={"subtype": y.astype(np.float32)}, variable_types={"subtype": "categorical"},
        features={k: [f"{k}{j}" for j in range(v.shape[1])] for k, v in dat.items()},
        samples=[f"s{i}" for i in range(n)],
        label_mappings={"subtype": {c: f"c{c}" for c in range(n_classes)}})


EPOCHS, BATCH = 3, 16


def _epoch_waits(spans, outer, step):
    """Per ``outer`` span, its host waits from its first ``step`` on, and
    those inside its ``engine.epoch_rows``: the epochs' waits, not the
    copies that set a round or the retrain up."""
    out = []
    for o in _named(spans, outer):
        first = min(spans[i][2] for i in _named(spans, step) if spans[i][1] == o)
        rows = {i for i in _named(spans, "engine.epoch_rows") if spans[i][1] == o}
        out.append(sum(1 for i in _named(spans, "host.wait")
                       if spans[i][1] in rows or (spans[i][1] == o and spans[i][2] >= first)))
    return out


def _tuner(n_iter, **space):
    tuner = HyperparameterTuning(_dataset(), DirectPred, "DirectPred", ["subtype"],
                                 n_iter=n_iter, batch_ask=4, early_stop_patience=-1,
                                 device="cpu")
    fixed = {"epochs": [EPOCHS], "batch_size": [BATCH], **space}
    for d in tuner.space.dimensions:
        if d.name in fixed:
            d.categories = fixed[d.name]
    return tuner


def test_tuning_job_counts_its_steps_and_waits():
    """Two pipelined rounds of 4 mixed architectures (padded), then the
    retrain: a round's epoch has 48 // 16 steps, the retrain's 60 // 16."""
    tuner = _tuner(8)
    with _cpu_profile():
        model, best = tuner.perform_tuning()
    spans, c = recorded()
    rounds, batches = 2, 48 // BATCH
    retrain_epochs = model.train_result.epochs_run
    assert c["tuner.jobs"] == 1 and c["tuner.rounds"] == rounds
    assert c["engine.steps"] == rounds * EPOCHS * batches
    assert c["engine.trial_samples"] == rounds * EPOCHS * batches * 4 * BATCH
    assert c["trainer.steps"] == retrain_epochs * (60 // BATCH)
    assert c["trainer.samples"] == c["trainer.steps"] * BATCH
    # a round's epoch: its row table's copy and its validation readback; the
    # retrain: each later epoch's row table's copy, then one readback of its losses
    assert _epoch_waits(spans, "tuner.round", "engine.step") == [2 * EPOCHS] * rounds
    assert _epoch_waits(spans, "tuner.retrain", "trainer.step") == [retrain_epochs]
    assert len(_named(spans, "host.wait")) == c["host.waits"]
    names = {s[0] for s in spans}
    assert {"tuner.job", "tuner.round", "tuner.retrain", "tuner.ask.pipelined", "tuner.ask",
            "engine.epoch_rows", "engine.step", "optim.update", "engine.validate",
            "trainer.step", "host.wait"} <= names
    assert len(_named(spans, "engine.step")) == c["engine.steps"]
    job = _named(spans, "tuner.job")[0]
    for i in _named(spans, "optim.update"):
        assert spans[spans[i][1]][0] == "engine.step"
    for i in _named(spans, "engine.step"):
        assert spans[spans[i][1]][0] == "tuner.round" and spans[spans[i][1]][1] == job
    for i in _named(spans, "trainer.step"):
        assert spans[spans[i][1]][0] == "tuner.retrain"


def test_same_architecture_round_counts_its_steps():
    tuner = _tuner(4)
    group = [{"latent_dim": 8, "hidden_dim_factor": 0.4, "lr": lr, "supervisor_hidden_dim": 8,
              "epochs": EPOCHS, "batch_size": BATCH} for lr in (1e-4, 1e-3, 1e-2)]
    with _cpu_profile():
        tuner._run_parallel_group(group)
    spans, c = recorded()
    assert c["tuner.rounds"] == 1 and "tuner.jobs" not in c
    assert c["engine.steps"] == EPOCHS * (48 // BATCH)
    assert c["engine.trial_samples"] == c["engine.steps"] * 3 * BATCH
    assert _epoch_waits(spans, "tuner.round", "engine.step") == [2 * EPOCHS]
    assert "trainer.steps" not in c
    assert len(_named(spans, "optim.update")) == c["engine.steps"]


def test_marker_pass_records_sums_and_table():
    ds = _dataset()
    model = DirectPred(config={"latent_dim": 8, "hidden_dim_factor": 0.3,
                               "supervisor_hidden_dim": 8}, dataset=ds,
                       target_variables=["subtype"], device="cpu")
    model.init_params(0)
    with _cpu_profile():
        rows = model.compute_feature_importance(ds, "subtype", steps_or_samples=5)
    spans, c = recorded()
    assert len(rows) == 3 * 20
    assert c["attribution.passes"] == 1 and c["attribution.samples"] == 60
    # the cohort's copy, the IG nodes' copy, one readback per class and layer
    assert c["host.waits"] == 1 + 1 + 3 * 2
    (p,) = _named(spans, "attribution.pass")
    (s,) = _named(spans, "attribution.sums")
    (t,) = _named(spans, "attribution.table")
    assert spans[s][1] == p and spans[t][1] == p
    dur = {i: spans[i][3] - spans[i][2] for i in (p, s, t)}
    assert dur[p] > dur[s] and dur[p] > dur[t]
    assert all(spans[i][1] in (s, t) or spans[spans[i][1]][1] == s
               for i in _named(spans, "host.wait"))


def test_trace_puts_spans_on_the_profilers_clock(tmp_path):
    a = torch.randn(256, 256)
    with trace(str(tmp_path / "tr"), "cpu"):
        time.sleep(0.001)
        with span("around.mm"):
            count("mms")
            a @ a
        time.sleep(0.001)
    data = json.loads((tmp_path / "tr" / "trace.json").read_text())
    events = data["traceEvents"]
    (mine,) = [e for e in events if e.get("name") == "around.mm"]
    assert mine["ph"] == "X" and mine["tid"] == "flexynesis spans"
    assert any(e.get("ph") == "M" and e.get("tid") == "flexynesis spans" for e in events)
    (mm,) = [e for e in events if e.get("name") == "aten::mm" and e.get("ph") == "X"]
    slack = 100.0   # microseconds
    assert mine["ts"] - slack <= mm["ts"]
    assert mm["ts"] + mm["dur"] <= mine["ts"] + mine["dur"] + slack
    summary = json.loads((tmp_path / "tr" / "spans.json").read_text())
    assert set(summary) == {"spans", "counters", "idle_s"}
    assert set(summary["spans"]["around.mm"]) == {"count", "total_s", "self_s"}
    assert summary["spans"]["around.mm"]["count"] == 1
    assert summary["counters"] == {"mms": 1} and summary["idle_s"] is None


def test_idle_seconds_go_to_the_innermost_span():
    """Device intervals and spans in one clock (ns): the gaps are 0-10
    (before every span: host), 20-40 (inner), 50-60 (outer) and 70-100."""
    spans = [("outer", -1, 6, 65), ("inner", 0, 15, 45)]
    idle = profiling._idle_by_span([(10, 20), (40, 50), (60, 70)], (0, 100), spans)
    assert idle == pytest.approx({"host": 40e-9, "inner": 20e-9, "outer": 10e-9})


def _reader(name):
    path = ROOT / "portbench" / "layer_metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"layer_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


MS = 1_000_000   # ns
HAND_MADE = (
    [("tuner.job", -1, 0, 900 * MS),
     ("engine.step", 0, 0, 10 * MS), ("optim.update", 1, 2 * MS, 6 * MS),
     ("host.wait", 1, 7 * MS, 8 * MS),
     ("engine.step", 0, 10 * MS, 18 * MS), ("optim.update", 4, 11 * MS, 14 * MS),
     ("trainer.step", 0, 20 * MS, 25 * MS), ("host.wait", 6, 21 * MS, 23 * MS),
     ("trainer.step", 0, 25 * MS, 28 * MS),
     ("host.wait", 0, 30 * MS, 130 * MS),
     ("attribution.pass", -1, 0, 50 * MS), ("attribution.sums", 10, 0, 30 * MS),
     ("host.wait", 11, 0, 4 * MS), ("attribution.table", 10, 30 * MS, 50 * MS),
     ("host.wait", 13, 31 * MS, 33 * MS), ("host.wait", 13, 35 * MS, 36 * MS)],
    {"tuner.jobs": 2, "engine.steps": 2, "trainer.steps": 2, "attribution.passes": 1,
     "host.waits": 6})
# spans 1-9 are a tuning job's, 10-15 a marker pass's; the readers of each
# cell count every host.wait of the recorder
WANT = {
    "engine.issue_ms.tune": ((10 - 4 - 1) + (8 - 3)) / 2,
    "optimizer.issue_ms.tune": (4 + 3) / 2,
    "trainer.issue_ms.tune": ((5 - 2) + 3) / 2,
    "host.wait_s.tune": (1 + 2 + 100 + 4 + 2 + 1) / 1000 / 2,
    "attribution.issue_ms.markers": (30 - 4) / 1,
    "attribution.table_ms.markers": (20 - 2 - 1) / 1,
    "host.wait_ms.markers": (1 + 2 + 100 + 4 + 2 + 1) / 1,
}


@pytest.mark.parametrize("name", sorted(WANT))
def test_layer_metric_readers(name, monkeypatch):
    read = _reader(name)
    monkeypatch.setattr(profiling, "recorded", lambda: HAND_MADE)
    assert read(None) == pytest.approx(WANT[name])
    monkeypatch.setattr(profiling, "recorded", lambda: ([], {}))
    assert read(None) is None


def test_readers_are_in_the_benchmark():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in WANT:
        assert entries[name]["source"] == "program_span"
        assert entries[name]["workloads"]
