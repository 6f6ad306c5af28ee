#!/usr/bin/env python3
"""What the port's spans cost and show on the CUDA card, in one benchmark cell.

    python3 tools/measure_spans.py --workload <cell> --seed <n> [--pairs 3]
        [--syncs] [--trace-dir DIR] --out chiprun_out/spans_<cell>.json

Sets the cell up as ``portbench/run.py`` does (its cohort, weights and
warm-up), then runs its profiled stretch (one tuning job, or the marker
passes) ``2 x --pairs`` times, in turns with the port's span recorder on and
forced off (the gate replaced by a closed one: the spans' cost and nothing
else differs). Each run gives the stretch's wall seconds, the card's busy and
idle share, kernel B3's roofline share where it runs, the benchmark's
per-layer metrics that read the spans, the spans' self and total seconds by
name, and the idle seconds the benchmark's breakdown gives each of its labels.

It also times one span on this host, off and on (``span_ns``).
``--syncs`` runs the stretch once more under
``torch.cuda.set_sync_debug_mode("warn")``: every call that makes the host
wait on the card, by its innermost frame in ``flexynesis_torch``, how often
it came and how often inside a ``host.wait`` span. ``--trace-dir`` runs the
stretch once more inside ``utils/profiling.trace`` (what ``--profile``
runs) and keeps its ``spans.json``, whose idle seconds are labelled by the
program's own spans. Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time
import traceback
import types
import warnings
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"

PACKAGE = str(ROOT / "flexynesis_torch")


def stretch(run):
    """The cell's profiled stretch, as the traced run makes it."""
    return run.profiled()


def span_cost_ns() -> dict:
    """Nanoseconds one span costs this host: off, and on under a CUDA-only
    profiler (as in the traced stretch)."""
    import timeit

    from torch.profiler import ProfilerActivity, profile

    from flexynesis_torch.utils import profiling

    def site():
        with profiling.span("cost"):
            pass

    n = 20000
    off = min(timeit.repeat(site, number=n, repeat=7)) / n * 1e9
    with profile(activities=[ProfilerActivity.CUDA]):
        on = min(timeit.repeat(site, number=n, repeat=7)) / n * 1e9
    profiling.clear()
    return {"off": off, "on": on}


def readings(cell, run, summary) -> dict:
    from flexynesis_torch.utils import profiling
    from portbench import core

    view = core.RunView(cell, {}, [], {}, profile=summary, least=run.kernel_least_seconds())
    metrics = {}
    for m in cell.per_layer:
        if m["source"] == "device_trace" or m["source"] == "program_span":
            value = core.layer_reader(m["name"])(view)
            if value is not None:
                metrics[m["name"]] = value
    spans, counters = profiling.recorded()
    table = profiling.summarise(spans)
    out = {"window_s": summary["window_s"], "busy_s": summary["busy_s"],
           "idle_pct": 100.0 * (1.0 - summary["busy_s"] / summary["window_s"]),
           "metrics": metrics, "gaps": summary["gaps"], "counters": counters,
           "n_spans": len(spans),
           "spans": {n: {"count": r["count"], "total_s": r["total_s"], "self_s": r["self_s"]}
                     for n, r in sorted(table.items())}}
    if table and cell.traffic["kind"] == "tune":
        # the program's host time that should hold the rounds' and the
        # retrain's idle seconds, as the breakdown labels them
        own = sum(table.get(n, {}).get(key, 0.0) for n, key in (
            ("engine.step", "self_s"), ("trainer.step", "self_s"),
            ("engine.epoch_rows", "total_s")))
        idle = summary["gaps"].get("round", 0.0) + summary["gaps"].get("retrain", 0.0)
        out["cross_check"] = {"step_self_and_rows_s": own, "round_retrain_idle_s": idle,
                              "share": own / idle if idle else None}
    return out


def syncs(run) -> dict:
    """Each call that made the host wait on the card during one stretch."""
    import torch

    from flexynesis_torch.utils import profiling

    found = []
    original = warnings.showwarning

    def hook(message, category, filename, lineno, file=None, line=None):
        if "synchronizing" not in str(message):
            return original(message, category, filename, lineno, file, line)
        t = time.perf_counter_ns()
        frames = [f for f in traceback.extract_stack()[:-1] if f.filename.startswith(PACKAGE)]
        if frames:   # the benchmark's own synchronisations are not the program's
            found.append((t, [f"{os.path.relpath(f.filename, ROOT)}:{f.lineno}"
                              for f in frames[-3:]]))

    profiling.clear()
    warnings.simplefilter("always")
    warnings.showwarning = hook
    torch.cuda.set_sync_debug_mode("warn")
    try:
        stretch(run)
    finally:
        torch.cuda.set_sync_debug_mode(0)
        warnings.showwarning = original
    spans, _ = profiling.recorded()
    waits = [(t0, t1) for n, _, t0, t1 in spans if n == "host.wait" and t1 is not None]
    sites = defaultdict(lambda: {"count": 0, "in_host_wait": 0, "chain": None})
    for t, chain in found:
        site = sites[chain[-1]]
        site["count"] += 1
        site["in_host_wait"] += any(t0 <= t <= t1 for t0, t1 in waits)
        site["chain"] = chain
    return dict(sorted(sites.items(), key=lambda kv: -kv[1]["count"]))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--pairs", type=int, default=3)
    p.add_argument("--syncs", action="store_true")
    p.add_argument("--trace-dir")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)

    import torch

    from flexynesis_torch.utils import profiling
    from portbench import core
    from portbench.trace import Tracer

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = core.load_cell(args.workload)
    core.set_precision(cell.config)
    tracer = Tracer(enabled=True, sync=torch.cuda.synchronize)
    ctx = core.Context(cell.config, cell.traffic, tracer, device, args.seed, cell.space_path)
    run = core.traffic_class(cell.traffic["kind"])(ctx)
    gate = profiling._profiler
    closed = types.SimpleNamespace(_is_profiler_enabled=False)
    result = {"workload": args.workload, "seed": args.seed,
              "card": torch.cuda.get_device_name(device), "power_limit": core.power_limit_w(),
              "runs": []}
    try:
        result["span_ns"] = span_cost_ns()
        print(json.dumps({"span_ns": result["span_ns"]}), flush=True)
        run.setup()
        for i in range(args.pairs):
            for on in ((True, False) if i % 2 == 0 else (False, True)):
                profiling._profiler = gate if on else closed
                profiling.clear()
                summary = stretch(run)
                profiling._profiler = gate
                row = readings(cell, run, summary)
                row["recorder"] = "on" if on else "off"
                result["runs"].append(row)
                print(json.dumps({k: row[k] for k in ("recorder", "window_s", "idle_pct",
                                                      "metrics")}), flush=True)
        if args.syncs:
            result["syncs"] = syncs(run)
            print(json.dumps(result["syncs"], indent=1), flush=True)
        if args.trace_dir:
            profiling.clear()
            shutil.rmtree(args.trace_dir, ignore_errors=True)
            with profiling.trace(args.trace_dir, device):
                if cell.traffic["kind"] == "tune":
                    run.job()
                else:
                    for _ in range(int(cell.traffic["profiled_passes"])):
                        run.one_pass()
            result["profile_spans"] = json.loads(
                (Path(args.trace_dir) / "spans.json").read_text())
    finally:
        profiling._profiler = gate
        run.close()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
