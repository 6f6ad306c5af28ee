#!/usr/bin/env python3
"""Where the marker-finding cell's widest importance gap comes from, seed by seed.

    python3 portbench/tools/markers_witness.py --seeds <n> [<n> ...]

For each seed: the cell's model and cohort as a run makes them, one pass of
the program on the card, the same pass of the program on the CPU in
float32 (a second witness), and the reference in float32 and float64. It
prints, one JSON line a seed, each side's gaps from float64, where the
program's widest gap on the card lies (class, feature), how the samples
share it, and, for the samples that carry most of it, the ReLU inputs at
the 25 IG points that lie within 1e-4 of their block's root mean square of
zero, where float32 rounding can flip the unit. Each such unit is flipped
alone in the float64 reference; a flip that moves the sample's attribution
onto the card's explains the gap by rounding.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

NEAR = 1e-4     # a ReLU input within this share of its block's RMS of zero


def forward64(p, stats, pts, layers, target, cfg, flip=None, near=None):
    """The reference's eval-mode logits, in float64, with one ReLU unit's
    mask inverted (``flip``: block, row, unit); ``near`` collects the
    (block, row, unit) of the inputs within ``NEAR`` of zero."""
    import torch

    def block(name, x):
        h = x @ p[f"{name}.W1"].T + p[f"{name}.b1"]
        h = (h - stats[f"{name}.rm"]) / torch.sqrt(stats[f"{name}.rv"] + float(cfg["bn_eps"]))
        u = h * p[f"{name}.g"] + p[f"{name}.beta"]
        mask = (u > 0).to(u.dtype)
        if flip is not None and flip[0] == name:
            mask[flip[1], flip[2]] = 1.0 - mask[flip[1], flip[2]]
        if near is not None:
            rms = float(u.detach().pow(2).mean().sqrt())
            for r, j in (u.detach().abs() < NEAR * rms).nonzero().tolist():
                near.append((name, r, j))
        out = (u * mask) @ p[f"{name}.W2"].T
        return out + p[f"{name}.b2"] if f"{name}.b2" in p else out

    emb = torch.cat([block(f"enc.{ln}", pts[ln]) for ln in layers], dim=-1)
    if len(layers) > 1:
        emb = emb @ p["fusion.W"].T + p["fusion.b"]
    return block(f"head.{target}", emb)


def sample_attr(p, stats, x1, layers, target, cfg, c, steps, flip=None):
    """One sample's IG attributions (every layer, float64) for class ``c``."""
    import numpy as np
    import torch

    nodes, weights = np.polynomial.legendre.leggauss(steps)
    alphas = torch.tensor((nodes + 1.0) * 0.5, dtype=torch.float64, device=x1[layers[0]].device)
    w = torch.tensor(weights * 0.5, dtype=torch.float64, device=alphas.device)
    pts = {ln: (alphas[:, None] * x1[ln]).requires_grad_(True) for ln in layers}
    logits = forward64(p, stats, pts, layers, target, cfg, flip)
    grads = torch.autograd.grad(logits[:, c].sum(), [pts[ln] for ln in layers])
    return torch.cat([x1[ln][0] * (w @ g) for ln, g in zip(layers, grads)])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--workload", default="directpred_markers")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--top", type=int, default=3, help="samples looked into")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from flexynesis_torch.interpret import attribution
    from flexynesis_torch.models import MODEL_REGISTRY
    from portbench import core
    from portbench.trace import Tracer

    cell = core.load_cell(args.workload)
    cfg, steps, mm = cell.config, int(cell.traffic["steps"]), cell.model_module
    core.set_precision(cfg)
    for seed in args.seeds:
        ctx = core.Context(cfg, cell.traffic, Tracer(False), torch.device(args.device), seed,
                           cell.space_path, mm)
        run = core.traffic_class(cell.traffic["kind"])(ctx)
        try:
            run.setup()
            card = run._table(run.one_pass())
        finally:
            run.close()
        # the second witness: the program on the CPU, the same weights and cohort
        cpu_model = MODEL_REGISTRY[cfg["model_class"]](
            config=dict(mm.arch_of(cfg), fused_kernels=False),
            dataset=mm.dataset(run.cohort, "train", cfg),
            target_variables=[cfg["target"]], device=torch.device("cpu"))
        cpu_model.module.load_state_dict({n: t.cpu() for n, t in run.state.items()},
                                         strict=False)
        cpu_model.module.eval()
        cpu = run._table(cpu_model.compute_feature_importance(
            run.test, cfg["target"], method=cell.traffic["method"], steps_or_samples=steps))
        r32 = run.readings()["imp"]
        r64 = run.witness()["imp"]
        line = {"seed": seed,
                "card_vs_ref32": run.gaps({"imp": card}, {"imp": r32}),
                "card_vs_ref64": run.gaps({"imp": card}, {"imp": r64}),
                "cpu_vs_ref64": run.gaps({"imp": cpu}, {"imp": r64}),
                "ref32_vs_ref64": run.gaps({"imp": r32}, {"imp": r64}),
                "card_vs_cpu": run.gaps({"imp": card}, {"imp": cpu})}

        # where the card's widest gap from float64 lies
        bounds = np.cumsum([0] + list(cfg["features"].values()))
        rel = np.zeros_like(r64)
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            rel[:, lo:hi] = (np.abs(card[:, lo:hi] - r64[:, lo:hi])
                             / np.abs(r64[:, lo:hi]).max(axis=1, keepdims=True))
        c, j = (int(v) for v in np.unravel_index(np.argmax(rel), rel.shape))
        line["widest"] = {"class": c, "feature": j, "gap": float(rel[c, j])}

        # the samples' shares: the program's per-sample |attr| on the card
        layers = list(cfg["features"])
        x = {ln: v[run.cohort.rows("test")] for ln, v in run.cohort.x.items()}
        with torch.enable_grad():
            attrs = attribution.integrated_gradients(
                lambda xs: run.model._attribution_forward(xs, cfg["target"]),
                {ln: x[ln].contiguous() for ln in layers}, [c], steps, False)[0]
        card_s = torch.cat([attrs[ln] for ln in layers], dim=1)[:, j].abs().double()
        params, stats = {}, {}
        for n, t in run.state.items():
            name = mm.canon(n)
            if name is not None:
                (stats if name.endswith((".rm", ".rv")) else params)[name] = t.double()
        x64 = {ln: v.double() for ln, v in x.items()}
        n = x64[layers[0]].shape[0]
        ref_s = torch.stack([
            sample_attr(params, stats, {ln: x64[ln][s: s + 1] for ln in layers}, layers,
                        cfg["target"], cfg, c, steps)[j].abs() for s in range(n)]).detach()
        diff = (card_s - ref_s).cpu()
        order = diff.abs().argsort(descending=True)
        total = float(diff.sum())
        line["samples"] = {"gap_sum": total, "n": n,
                           "top_share": [float(diff[i]) / total if total else 0.0
                                         for i in order[: args.top]]}
        alphas = torch.tensor((np.polynomial.legendre.leggauss(steps)[0] + 1) * 0.5,
                              dtype=torch.float64, device=x64[layers[0]].device)[:, None]
        looks, counts = [], []
        for s in range(n):
            near = []
            with torch.no_grad():
                forward64(params, stats, {ln: alphas * x64[ln][s: s + 1] for ln in layers},
                          layers, cfg["target"], cfg, near=near)
            counts.append(len(near))
            if s in order[: args.top].tolist():
                x1 = {ln: x64[ln][s: s + 1] for ln in layers}
                base = float(ref_s[s])
                best = None
                for unit in near:
                    moved = float(sample_attr(params, stats, x1, layers, cfg["target"], cfg, c,
                                              steps, flip=unit)[j].abs())
                    left = abs(float(card_s[s]) - moved) / max(abs(float(card_s[s]) - base),
                                                               1e-300)
                    if best is None or left < best[0]:
                        best = (left, unit, moved)
                looks.append({"sample": s, "card": float(card_s[s]), "ref64": base,
                              "near_units": near,
                              "best_flip": None if best is None else
                              {"left_of_gap": best[0], "unit": best[1], "attr": best[2]}})
        line["near_per_sample"] = {"median": float(np.median(counts)), "max": int(max(counts)),
                                   "samples_with_any": int(sum(k > 0 for k in counts))}
        line["looks"] = looks
        print(json.dumps(line), flush=True)
        del run
        if args.device == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
