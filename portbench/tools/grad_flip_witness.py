#!/usr/bin/env python3
"""Whether a ReLU input within rounding of zero parts the program's first
gradient of one round trial from the reference's.

    python3 portbench/tools/grad_flip_witness.py --seed <n> [--flips 8]

Sets up ``directpred_tune_default`` on the seed and runs one job. For the
trial whose worst leaf parts most from the reference, the first step is
followed by the reference in float64: the unclipped gradient's global norm
against the clip, the smallest ReLU inputs (each over its block's RMS), and
every leaf's gap against the program, first as is and then with each of the
smallest inputs' ReLU flipped in turn. One JSON line on standard output.
Runs on the card; ``--device cpu`` rehearses.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", default="directpred_tune_default")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--flips", type=int, default=8)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from portbench import adapt, core
    from portbench.compare import leaf_gaps, median, norms
    from portbench.reference import adam as ref_adam
    from portbench.reference import models as ref_models
    from portbench.trace import Tracer

    cell = core.load_cell(args.workload)
    device = torch.device(args.device)
    core.set_precision(cell.config)
    ctx = core.Context(cell.config, cell.traffic, Tracer(False), device, args.seed,
                       cell.space_path)
    run = core.traffic_class(cell.traffic["kind"])(ctx)
    try:
        run.setup()
        run.window(args.seconds)
    finally:
        run.close()
    got, ref = run.program_readings(), run.readings()
    k, _ = run.round_grad_gaps(got["round"], ref["round"], True)["x.round.grad_worst_at"]
    rec, cfg, f64 = run.round_rec, run.cfg, torch.float64
    w = adapt.widths(rec.arch[k], run.input_dims)
    p0, s0, bf16 = run._ref_start(rec, k, True)
    rows = rec.rows[0]
    rows = rows[k] if rows.dim() == 2 else rows
    draws = [(kind, t.to(f64)) for kind, t in run._keeps(rec, rec.noise[0], k, w, True)]
    x, y = run._data(rows.to(run.cohort.y.device))
    x = {n: t.to(f64) for n, t in x.items()}
    params = {n: t.to(f64) for n, t in p0.items()}
    stats = {n: t.to(f64) for n, t in s0.items()}
    lr = float(np.float32(rec.arch[k]["lr"]))
    program = got["round"][k]["grad"]

    def first_gradient(flip=None):
        """Leaf norms of the clipped first gradient, the ReLU inputs of each
        block and the unclipped global norm; ``flip`` = (block call, row,
        unit) puts that input's ReLU on its other side."""
        seen, relu = [], torch.relu

        def flipped(u):
            mask = u > 0
            if flip is not None and flip[0] == len(seen):
                mask = mask.clone()
                mask[flip[1], flip[2]] = ~mask[flip[1], flip[2]]
            seen.append(u.detach())
            return torch.where(mask, u, torch.zeros_like(u))
        torch.relu = flipped
        try:
            _, grads = ref_models.train_loss_and_grads(
                cfg["model_class"], params, dict(stats), x, y, run.layers, cfg["target"],
                draws, cfg)
        finally:
            torch.relu = relu
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
        opt = ref_adam.Adam(params, lr, cfg, bf16=bf16, generator=gen, dtype=f64)
        opt.step(params, grads)
        total = float(torch.sqrt(sum(g.square().sum() for g in grads.values())))
        return norms({n: opt.first_gradient(n) for n in params}), seen, total

    def against_program(want):
        gaps = leaf_gaps(program, want, run._live({"grad": want, "params": list(want)}))
        worst = max(gaps, key=gaps.get)
        return {"median": median(list(gaps.values())), "worst": gaps[worst], "worst_leaf": worst}

    want, seen, total = first_gradient()
    near = []
    for i, u in enumerate(seen):
        rel = (u.abs() / u.square().mean().sqrt()).flatten()
        vals, idx = torch.topk(rel, min(args.flips, rel.numel()), largest=False)
        near += [(float(v), i, int(j) // u.shape[1], int(j) % u.shape[1])
                 for v, j in zip(vals, idx)]
    near = sorted(near)[: args.flips]
    line = {"seed": args.seed, "trial": k, "lr": lr, "clip": float(cfg["grad_clip"]),
            "unclipped_norm": total, "program_vs_ref64": against_program(want),
            "flips": []}
    for rel, i, r, j in near:
        flipped, _, norm = first_gradient((i, r, j))
        line["flips"].append({"block_call": i, "row": r, "unit": j, "input_over_rms": rel,
                              "unclipped_norm": norm, **against_program(flipped)})
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
