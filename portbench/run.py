#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Measures ``flexynesis_torch`` on the CUDA card this process is started on
(never on the CPU), checks what the timed path produced against the plain
reference, and prints one JSON object as the last line of standard output;
the compared numbers, each beside its limit, are the last lines of standard
error. Exits non-zero, printing no result, without a card, with fewer cards
than the cell asks for, or if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# one process with few threads: the host issues the card's work, and BLAS or
# OpenMP workers competing with it for cores would set a run's speed
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
# every build and kernel cache of the run stays in the checkout, at fixed paths
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "nv_cache")):
    os.environ[var] = str(ROOT / "build" / "portbench" / sub)
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from portbench import core
    from portbench.compare import stderr_lines

    cell = core.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark measures the card only", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} cards, {torch.cuda.device_count()} found",
              file=sys.stderr)
        return 2
    result, checks = core.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                                   torch.device("cuda", 0))
    found = core.forbidden_modules()
    if found:
        print(f"the run loaded {', '.join(found)}: the port must run without JAX",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for line in stderr_lines(checks):
        print(line, file=sys.stderr)
    return 0


if __name__ == "__main__":
    # one fixed hash seed, so that nothing a run does in set or dict order
    # differs from one process to the next; set before the interpreter
    # starts, so the process starts itself again once, under the same id
    if os.environ.get("PYTHONHASHSEED") != "0":
        os.environ["PYTHONHASHSEED"] = "0"
        os.execv(sys.executable, [sys.executable, *sys.argv])
    sys.exit(main())
