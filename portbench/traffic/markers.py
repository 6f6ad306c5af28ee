"""Traffic kind ``markers``: the CLI's marker finding, pass after pass.

The window calls ``model.compute_feature_importance(test, target,
method=..., steps_or_samples=...)`` on the test cohort over and over, as
the training CLI's ``_write_feature_importances`` calls it after a run, and
writes no file. The model is an unfused DirectPred whose weights and
running statistics the benchmark makes on the device from the seed, in one
draw, and hands to the reference as well. The work is the cohort's samples
attributed, every class of the target each time.

Once the window has closed, the importances of a sample of its passes
(drawn from the seed; the first and the last always among them) are held
against the reference's integrated gradients (``reference/ig.py``).
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from .. import adapt, work
from ..compare import tf32
from ..data import make_cohort, to_dataset
from ..reference import ig as ref_ig
from ..trace import Hooks, Profiled


def seeded_state(module: torch.nn.Module, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter and running statistic of ``module`` from one uniform
    draw on the device: Linear weights and biases U(+-1/sqrt(fan_in)),
    BatchNorm scales U(0.5, 1.5) and shifts U(-0.1, 0.1), running means
    U(-0.1, 0.1) and variances U(0.5, 1.5), loss weights 0."""
    state = {n: t for n, t in module.state_dict().items()
             if not n.endswith("num_batches_tracked")}
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63) ^ 0x5DEECE66D)
    total = sum(t.numel() for t in state.values())
    u = torch.rand(total, generator=gen, device=device) * 2 - 1   # U(-1, 1)
    out, at = {}, 0
    for n, t in state.items():
        part = u[at: at + t.numel()].view(t.shape)
        at += t.numel()
        leaf = n.rsplit(".", 1)[-1]
        if n.startswith("log_var_"):
            v = torch.zeros_like(part)
        elif leaf in ("running_var",) or n.endswith("batchnorm.weight"):
            v = 1.0 + 0.5 * part
        elif leaf == "running_mean" or n.endswith("batchnorm.bias"):
            v = 0.1 * part
        else:
            linear = n.rsplit(".", 1)[0]
            fan_in = state[f"{linear}.weight"].shape[1]
            v = part / fan_in ** 0.5
        out[n] = v.contiguous()
    return out


class Markers:
    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg = ctx.config
        self.traffic = ctx.traffic
        self.tracer = ctx.tracer
        self.device = ctx.device
        self.hooks = Hooks()

    def setup(self):
        from flexynesis_torch.interpret import attribution
        from flexynesis_torch.models.direct_pred import DirectPred

        cfg = self.cfg
        self.cohort = make_cohort(cfg, self.ctx.seed, self.device)
        train = to_dataset(self.cohort, "train", cfg["target"])
        self.test = to_dataset(self.cohort, "test", cfg["target"])
        arch = {k: cfg[k] for k in ("latent_dim", "hidden_dim_factor", "supervisor_hidden_dim")}
        self.model = DirectPred(config=dict(arch, fused_kernels=False), dataset=train,
                                target_variables=[cfg["target"]], device=self.device)
        self.state = seeded_state(self.model.module, self.ctx.seed, self.device)
        self.model.module.load_state_dict(self.state, strict=False)
        self.model.module.eval()
        # every product lies on the path to the one target's logits
        self.n_params = work.matmul_params("DirectPred", arch, list(work.dims_of(cfg).values()),
                                           int(cfg["n_classes"]))
        tr = self.tracer

        def sums(orig):
            def wrapped(*a, **kw):
                with tr.span("attribution", sync=True):
                    return orig(*a, **kw)
            return wrapped

        self.hooks.wrap(attribution, "abs_attribution_sums", sums)
        self.one_pass()   # the shapes of a pass, warmed
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        tr.counters.clear()
        tr.spans.clear()

    def one_pass(self) -> List[dict]:
        tp = self.traffic
        with self.tracer.span("pass"):
            rows = self.model.compute_feature_importance(
                self.test, self.cfg["target"], method=tp["method"],
                steps_or_samples=int(tp["steps"]))
        n = len(self.test)
        c = self.tracer.counters
        c["samples"] += n
        c["passes"] += 1
        c["flops"] += work.ig_flops(self.n_params, n * int(tp["steps"]),
                                    int(self.cfg["n_classes"]))
        return rows

    def window(self, seconds: float) -> dict:
        """Passes until ``seconds`` have passed. The passes compared are the
        first, the last and ``sample_passes`` drawn uniformly from the seed
        (a reservoir sample, one draw a pass)."""
        rng = np.random.default_rng(int(self.ctx.seed) % (2 ** 63))
        k = int(self.traffic["sample_passes"])
        sample: List[tuple] = []
        t0 = time.perf_counter()
        i = 0
        while True:
            rows = self.one_pass()
            if i == 0:
                first = rows
            elif len(sample) < k:
                sample.append((i, rows))
            else:
                j = int(rng.integers(0, i))
                if j < k:
                    sample[j] = (i, rows)
            last = rows
            i += 1
            if time.perf_counter() - t0 >= seconds:
                break
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        self.kept: Dict[int, List[dict]] = {0: first, **dict(sample), i - 1: last}
        c = self.tracer.counters
        return {"seconds": elapsed, "passes": i, "samples": c["samples"], "flops": c["flops"],
                "attempted": i, "failed": 0}

    def profiled(self) -> dict:
        passes = int(self.traffic["profiled_passes"])
        with Profiled(self.tracer) as prof:
            for _ in range(passes):
                self.one_pass()
        return prof.summary

    def kernel_least_seconds(self) -> dict:
        return {}

    def close(self):
        self.hooks.restore()

    # ------------------------------------------------------- reference

    def _reference(self, fault=None, dtype=torch.float32) -> np.ndarray:
        cfg = self.cfg
        params, stats = {}, {}
        for n, t in self.state.items():
            name = adapt.canon(n)
            if name is None:
                continue
            t = t.to(dtype)
            (stats if name.endswith((".rm", ".rv")) else params)[name] = t
        x = {ln: v[self.cohort.rows("test")].to(dtype) for ln, v in self.cohort.x.items()}
        if fault == "half":   # the planted fault: half the cohort, the mean over the rest
            x = {ln: v[: v.shape[0] // 2] for ln, v in x.items()}
        return ref_ig.importances(params, stats, x, list(x), cfg["target"], int(cfg["n_classes"]),
                                  int(self.traffic["steps"]), cfg)

    def _table(self, rows: List[dict]) -> np.ndarray:
        """(classes, features) importances of a pass, layers in order; raises
        where the rows are not one per class and feature in that order."""
        cfg = self.cfg
        names = [f"{ln}_f{j}" for ln, f in cfg["features"].items() for j in range(f)]
        C = int(cfg["n_classes"])
        if len(rows) != C * len(names):
            raise ValueError(f"{len(rows)} rows, expected {C * len(names)}")
        table = np.empty((C, len(names)))
        for i, r in enumerate(rows):
            c, j = divmod(i, len(names))
            if r["target_class"] != c or r["name"] != names[j]:
                raise ValueError(f"row {i} is class {r['target_class']} {r['name']}, "
                                 f"expected class {c} {names[j]}")
            table[c, j] = r["importance"]
        return table

    def witness(self) -> dict:
        """The reference's importances in float64: a second witness."""
        return {"imp": self._reference(dtype=torch.float64)}

    def readings(self, control: bool = False, seed_shift: int = 0, fault=None) -> dict:
        """The reference's importances (``control``: with TF32 products)."""
        with tf32(control):
            return {"imp": self._reference(fault)}

    def program_readings(self) -> dict:
        tables = []
        for rows in self.kept.values():
            tables.append(self._table(rows))
        return {"imp": tables}

    def gaps(self, got: dict, ref: dict, details: bool = False) -> Dict[str, float]:
        """The gaps of a pass's importances from the reference's, each over
        the largest importance of its class and layer, worst over the kept
        passes: the median feature's (steady: TF32 moves every feature) and
        the widest feature's (an altered answer). The widest moves with the
        IG points whose ReLU pre-activation lies within rounding of zero,
        which part two float32 runs (PERF.md), so its limit sits above that
        and below the planted faults."""
        want = ref["imp"]
        tables = got["imp"] if isinstance(got["imp"], list) else [got["imp"]]
        bounds = np.cumsum([0] + list(self.cfg["features"].values()))
        med = widest = 0.0
        for t in tables:
            gaps = np.concatenate([
                (np.abs(t[:, lo:hi] - want[:, lo:hi])
                 / np.abs(want[:, lo:hi]).max(axis=1, keepdims=True)).ravel()
                for lo, hi in zip(bounds[:-1], bounds[1:])])
            med, widest = max(med, float(np.median(gaps))), max(widest, float(gaps.max()))
        return {"importance_med": med, "importance": widest}

TRAFFIC = Markers
