#!/usr/bin/env python3
"""The readings that a cell's limits are set from, many seeds in one process.

    python3 portbench/tools/readings.py --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...] [--control-seeds <n> [<n> ...]]

For each seed: the cell's set-up and a window of ``--seconds`` (at least one
whole job or pass), then the compared numbers of the program against the
reference. For each control seed also those of the control (the reference
computed with TF32 products, in the program's place) and of a planted fault
(the reference on half of each batch, its mean over the rest); with
``--witness`` also the round and the retrain followed in float64, against
which both the program and the float32 reference are read, and the reference against
itself with other stochastic-rounding bits (the floor that the rounding
alone sets under each number). One JSON line per seed on
standard output. Runs on the card; ``--device cpu`` rehearses.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--witness", action="store_true",
                   help="also follow the retrain in float64 (tuning cells)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import torch

    from portbench import core
    from portbench.trace import Tracer

    cell = core.load_cell(args.workload)
    device = torch.device(args.device)
    core.set_precision(cell.config)
    for seed in list(dict.fromkeys(args.seeds + args.control_seeds)):
        t0 = time.perf_counter()
        ctx = core.Context(cell.config, cell.traffic, Tracer(False), device, seed,
                           cell.space_path)
        run = core.traffic_class(cell.traffic["kind"])(ctx)
        try:
            run.setup()
            window = run.window(args.seconds)
        finally:
            run.close()
        got = run.program_readings()
        ref = run.readings(control=False)
        line = {"seed": seed, "window": window, "program": run.gaps(got, ref, details=True)}
        if args.witness:
            w64 = run.witness()
            if "round" in ref:   # a tuning cell: the retrain in float64, and the rounding floor
                line["witness"] = {
                    "ref32_vs_ref64": run.retrain_gaps(ref["retrain"], w64["retrain"], True),
                    "program_vs_ref64": run.retrain_gaps(got["retrain"], w64["retrain"], True),
                    "round_ref32_vs_ref64": run.round_grad_gaps(ref["round"], w64["round"], True),
                    "round_program_vs_ref64": run.round_grad_gaps(got["round"], w64["round"],
                                                                  True)}
                line["sr_floor"] = run.gaps(run.readings(seed_shift=3), ref, details=True)
            else:
                line["witness"] = {"ref32_vs_ref64": run.gaps(ref, w64),
                                   "program_vs_ref64": run.gaps(got, w64)}
        if seed in args.control_seeds:
            line["control"] = run.gaps(run.readings(control=True, seed_shift=1), ref)
            line["half"] = run.gaps(run.readings(seed_shift=2, fault="half"), ref)
            if "round" in ref:
                line["stale"] = run.gaps(run.readings(seed_shift=2, fault="stale"), ref)
        line["s"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        del run
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
