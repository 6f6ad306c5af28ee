"""One run of one cell: find its files by name, set up, measure, check.

Everything a cell needs is found from its name in ``BENCHMARK.json``:
the configuration's file, its model class's module
``classes/<model_class>.py``, ``traffic/<traffic>.json`` (the mix's parameters
and its ``kind``), the generator ``traffic/<kind>.py``, the cell's
``workloads/<cell>.json`` (the limits of its comparison) and, for a tuning
cell, ``workloads/<cell>.space.yaml``; each per-layer metric is read by
``layer_metrics/<metric>.py``.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import subprocess
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

from .compare import Check, as_json
from .trace import Tracer, kernel_seconds, top

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CLASSES = HERE / "classes"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "flexynesis_tpu")
# what a model class's module defines; the harness reaches a class through these alone
CLASS_NAMES = ("dataset", "arch_of", "canon", "widths", "rows_of", "keep_width", "init_law",
               "matmul_shapes", "noise_sites", "train_loss_and_grads", "eval_loss",
               "noise_blocks", "eval_forward")


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    space_path: Optional[Path]
    end_to_end: list
    per_layer: list
    model_module: object


def model_module(model_class: str):
    """The module of ``model_class``: ``classes/<model_class>.py``, letter for
    letter."""
    path = CLASSES / f"{model_class}.py"
    shown = path.relative_to(ROOT) if path.is_relative_to(ROOT) else path
    if not path.is_file():
        raise FileNotFoundError(f"no module for model class {model_class!r}: add {shown}, "
                                f"defining {', '.join(CLASS_NAMES)}")
    spec = importlib.util.spec_from_file_location(f"portbench.classes.{model_class}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    missing = [n for n in CLASS_NAMES if not hasattr(module, n)]
    if missing:
        raise AttributeError(f"{shown} does not define {', '.join(missing)}")
    return module


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: Optional[dict] = None) -> Cell:
    bench = bench or manifest()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = json.loads((ROOT / conf["file"]).read_text())
    workload = json.loads((HERE / "workloads" / f"{name}.json").read_text())
    space = HERE / "workloads" / f"{name}.space.yaml"
    return Cell(
        name=name, chips=int(entry["chips"]), config=config,
        traffic=json.loads((HERE / "traffic" / f"{entry['traffic']}.json").read_text()),
        limits=workload["limits"], space_path=space if space.exists() else None,
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
        model_module=model_module(config["model_class"]))


def traffic_class(kind: str):
    return importlib.import_module(f"portbench.traffic.{kind}").TRAFFIC


def layer_reader(metric: str):
    path = HERE / "layer_metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_layer_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def process_age_s() -> float:
    """Seconds since this process started (Linux ``/proc``)."""
    fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return float(Path("/proc/uptime").read_text().split()[0]) - start


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


CARD_STATE = "clocks.sm,clocks.max.sm,clocks.mem,temperature.gpu,power.draw"


def card_state() -> Optional[dict]:
    """The card's clocks (MHz), temperature (C) and power draw (W) now."""
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={CARD_STATE}",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    values = out.stdout.strip().split(", ")
    return dict(zip(CARD_STATE.split(","), values)) if len(values) == 5 else None


def power_limit_w() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
                              "-i", "0"], capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() or None


@dataclass
class Context:
    config: dict
    traffic: dict
    tracer: Tracer
    device: object
    seed: int
    space_path: Optional[Path]
    model_module: object


@dataclass
class RunView:
    """What a per-layer reader reads: the window's spans and counters, the
    profiled stretch's device summary and each kernel's least seconds."""
    cell: Cell
    window: dict
    spans: list
    counters: dict
    profile: Optional[dict] = None
    least: dict = field(default_factory=dict)

    def span_total(self, name: str) -> float:
        return sum(t1 - t0 for n, t0, t1 in self.spans if n == name)

    def kernel_seconds(self, needles) -> float:
        return kernel_seconds(self.profile["kernels"], needles) if self.profile else 0.0


def set_precision(config: dict) -> None:
    import torch

    allow = bool(config["allow_tf32"])
    torch.backends.cuda.matmul.allow_tf32 = allow
    torch.backends.cudnn.allow_tf32 = allow


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device) -> tuple:
    """(result line, checks) of one run. ``device`` is the card; the tests
    drive the same path on the CPU at small sizes."""
    import torch

    set_precision(cell.config)
    cuda = device.type == "cuda"
    tracer = Tracer(enabled=trace, sync=torch.cuda.synchronize if cuda else None)
    ctx = Context(cell.config, cell.traffic, tracer, device, int(seed), cell.space_path,
                  cell.model_module)
    run = traffic_class(cell.traffic["kind"])(ctx)
    try:
        run.setup()
        setup_s = process_age_s()
        window = run.window(seconds)
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        # what a run's speed may hang on beyond the code: the card's clocks
        # at the window's close, the host's load and the cores this process has
        window["card"] = card_state() if cuda else None
        window["host"] = {"load_1m": os.getloadavg()[0], "cores": len(os.sched_getaffinity(0))}
        view = RunView(cell, window, list(tracer.spans), dict(tracer.counters))
        metrics = {}
        rate = window["samples"] / window["seconds"]
        for m in cell.end_to_end:
            value = setup_s if m["name"] == "setup_s" else rate
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        breakdown = None
        if trace:
            view.profile = run.profiled()
            view.least = run.kernel_least_seconds()
            metrics = {}
            for m in cell.per_layer:
                value = layer_reader(m["name"])(view)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            breakdown = {"device_ops": top(view.profile["kernels"]),
                         "idle_gaps": top(view.profile["gaps"])}
    finally:
        run.close()
    try:
        checks = judge(run, cell.limits)
    except Exception as exc:  # a capture or comparison that could not finish fails the run
        print(f"the comparison could not finish: {exc!r}", file=sys.stderr)
        checks = [Check("comparison_ran", 1.0, 0.0)]
    device_info = {"platform": "gpu" if cuda else device.type,
                   "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                   "count": cell.chips, "memory_peak_bytes": int(peak)}
    if cuda:
        device_info["power_limit"] = power_limit_w()
    if trace:
        device_info["busy_s"] = view.profile["busy_s"]
        device_info["window_s"] = view.profile["window_s"]
    result = {"correct": bool(checks) and all(c.ok for c in checks),
              "attempted": int(window["attempted"]), "failed": int(window["failed"]),
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["window"] = window
    result["checks"] = as_json(checks)
    print(f"window: {json.dumps(window)}", file=sys.stderr)
    return result, checks


def judge(run, limits: dict) -> list:
    """The compared numbers of a run against the cell's limits; a number
    without a limit fails."""
    got = run.program_readings()
    ref = run.readings(control=False)
    gaps = run.gaps(got, ref)
    return [Check(name, value, limits.get(name)) if name in limits
            else Check(name, value, float("nan")) for name, value in gaps.items()]
