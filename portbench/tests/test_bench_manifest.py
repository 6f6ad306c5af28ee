"""BENCHMARK.json and the files it names: present, loadable, within the
contract's characters and limits, and every per-layer metric reported
where its end-to-end metric is."""

from __future__ import annotations

import json
import re

import pytest

from conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
HERE = ROOT / "portbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def _cells_of(metric):
    return metric.get("workloads", CELLS)


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names_and_units(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in entry.get("reduced", []):
        assert NAME.match(key)
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200
            assert "\n" not in entry[key] and "\t" not in entry[key]


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(conf):
    from portbench import core

    cfg = json.loads((ROOT / conf["file"]).read_text())
    assert cfg["reduced"] == conf["reduced"]
    assert {"model_class", "features", "n_train", "n_test", "n_classes", "precision",
            "allow_tf32"} <= set(cfg)
    arch = core.model_module(cfg["model_class"]).arch_of(cfg)   # raises on a missing key
    assert arch and all(k in cfg for k in arch)


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files(cell):
    from portbench import core

    loaded = core.load_cell(cell["name"])
    assert loaded.chips == 1
    assert (HERE / "traffic" / f"{loaded.traffic['kind']}.py").exists()
    assert loaded.limits, "a cell's comparison has limits"
    assert any(m["name"] == "setup_s" for m in loaded.end_to_end)
    assert len(loaded.end_to_end) >= 2 and loaded.per_layer


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_layer_metric_readers(metric):
    from portbench import core

    assert callable(core.layer_reader(metric["name"]))
    moves = next(m for m in BENCH["end_to_end"] if m["name"] == metric["moves"])
    assert set(_cells_of(metric)) <= set(_cells_of(moves))
    if "roofline" in metric["name"] or "mfu" in metric["name"]:
        assert metric["unit"] == "%"


@pytest.mark.parametrize("metric", BENCH["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end(metric):
    assert metric["source"] in ("host_clock", "device_trace")
    assert 0.01 <= metric["bound"] <= 0.25


def test_result_line_keys(tiny_cell):
    import torch

    from portbench import core

    result, _ = core.run_cell(tiny_cell("directpred_markers"), 2 ** 33 + 7, 0.2, False,
                              torch.device("cpu"))
    keys = list(result)
    assert keys[-1] == "checks"
    assert set(keys) <= {"correct", "attempted", "failed", "metrics", "device", "breakdown",
                         "window", "checks"}
    assert {"card", "host"} <= set(result["window"])
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(keys)
    assert set(result["metrics"]) == {"attrib_samples_per_s", "setup_s"}
