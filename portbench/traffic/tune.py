"""Traffic kind ``tune``: the CLI's tuning job (``hpo_fit``), run whole, back to back.

A job is ``HyperparameterTuning(...).perform_tuning()`` on the training
cohort with the cell's search space (``workloads/<cell>.space.yaml``):
GP rounds of ``trials_per_round`` suggestions on the trial engine, then the
best configuration's full-data retrain. The window runs jobs until
``--seconds`` have passed and ends with the job that is running then. The
work is every trial-sample that went through an optimizer step: a stacked
step of K trials on B rows is K x B (a padded trial counts as one), a
retrain step B.

Hooks around the program's calls count that work, put spans (round,
validation, retrain, ask) on the host clock, and, in the window's first job,
hand the program what the benchmark makes and record what the program did
with it. The benchmark makes every model's starting weights from the seed
(``seeded_start``, the published initialisation), loaded where the program
initialises a model, and, in the first three steps of the first round and of
the retrain and in the round's compared validation, the dropout and normal
noise, drawn from the benchmark's own generators. The program's first
validation of that round is also run once at its start. The records are the
rows, the losses, the optimizer's first moments after one step and the state
after three. Once the window has closed, the reference (``reference/``)
works out each trial's start from the benchmark's draw itself, thresholds the
benchmark's uniforms at each dropout site's own rate (the class module's
``noise_blocks``), and redoes those steps and that validation in plain
float32.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import adapt, work
from ..compare import (leaf_gaps, live_leaves, median, norms, rel_gap, start_gap, tf32,
                       worst_leaf)
from ..data import make_cohort
from ..reference import adam as ref_adam
from ..reference import init as ref_init
from ..trace import Hooks, Profiled

STEPS = 3  # steps the reference follows, in the round and in the retrain


def _clone(tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {n: t.detach().clone() for n, t in tree.items()}


@torch.no_grad()
def _copy_into(tree: Dict[str, torch.Tensor], values: Dict[str, torch.Tensor]) -> None:
    for n, t in tree.items():
        t.copy_(values[n])


def _mix(*keys: int) -> int:
    """One generator seed from several whole numbers (a run's seed may pass
    32 bits)."""
    out = 0x5DEECE66D
    for k in keys:
        out = (out * 1000003 + int(k)) % (2 ** 63)
    return out


def seeded_start(module: torch.nn.Module, model_module, seed: int, model_seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """Every parameter and running statistic of ``module``, by the state's
    names, as the published initialisation draws them (``reference/init.py``,
    each leaf's law from the class module's ``init_law``), from one uniform
    draw on the device keyed by the run's ``seed`` and the seed the program
    initialises this model with."""
    canon = model_module.canon
    state = {n: t for n, t in module.state_dict().items() if canon(n) is not None}
    shapes = {canon(n): tuple(t.shape) for n, t in state.items()}
    gen = torch.Generator(device=device)
    gen.manual_seed(_mix(seed, model_seed))
    total = sum(t.numel() for t in state.values())
    u = torch.rand(total, generator=gen, device=device) * 2 - 1   # U(-1, 1)
    out, at = {}, 0
    for n, t in state.items():
        part = u[at: at + t.numel()].view(t.shape)
        at += t.numel()
        name = canon(n)
        kind = model_module.init_law(name)
        out[n] = ref_init.fill(part, name, kind, shapes).to(t.dtype).contiguous()
    return out


class _Record:
    """What one captured stretch of training holds."""

    def __init__(self):
        self.owner = None
        self.step = 0
        self.seeds: list = []
        self.start: List[Dict[str, torch.Tensor]] = []
        self.init: Dict[str, torch.Tensor] = {}
        self.init_buffers: Dict[str, torch.Tensor] = {}
        self.rows: List[torch.Tensor] = []
        self.losses: List[torch.Tensor] = []
        self.noise: List[list] = []
        self.first_m: Dict[str, torch.Tensor] = {}
        self.after: Dict[str, torch.Tensor] = {}
        self.after_buffers: Dict[str, torch.Tensor] = {}
        self.arch: list = []
        self.val: Optional[dict] = None
        self.val_idx = None
        self.done = False


class Tune:
    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg = ctx.config
        self.mm = ctx.model_module   # the model class's module (``classes/``)
        self.traffic = ctx.traffic
        self.tracer = ctx.tracer
        self.device = ctx.device
        self.hooks = Hooks()
        self.capture = False
        self.round_rec = _Record()
        self.retrain_rec = _Record()
        self.cur_params: Optional[List[int]] = None
        self.kernel_calls: Dict[str, list] = {"b3": []}
        self.record_kernels = False
        self.in_retrain = False
        # the benchmark's starts of the models the window's first job
        # initialised: by (module, the program's seed), and each module's last
        self.starts: Dict[tuple, Dict[str, torch.Tensor]] = {}
        self.last_start: Dict[int, Dict[str, torch.Tensor]] = {}
        # the benchmark's noise generators, by device, and their replays
        self._gens: Dict[str, tuple] = {}
        self._draws: Optional[list] = None

    # ----------------------------------------------------------- set-up

    def setup(self):
        from flexynesis_torch.models import MODEL_REGISTRY

        cfg = self.cfg
        self.model_class = MODEL_REGISTRY[cfg["model_class"]]
        self.cohort = make_cohort(cfg, self.ctx.seed, self.device)
        self.train_ds = self.mm.dataset(self.cohort, "train", cfg)
        self.input_dims = work.dims_of(cfg)
        self.layers = list(self.input_dims)
        self._install()
        # warm every path of the job (both rounds, the pipelined ask, the
        # retrain) at one epoch a trial
        self.job(epochs=1)
        torch.cuda.synchronize() if self.device.type == "cuda" else None
        self.tracer.counters.clear()
        self.tracer.spans.clear()

    def job(self, n_iter: Optional[int] = None, epochs: Optional[int] = None):
        from flexynesis_torch.train.hpo import HyperparameterTuning
        from flexynesis_torch.train.space import Categorical

        tp = self.traffic
        tuner = HyperparameterTuning(
            dataset=self.train_ds, model_class=self.model_class,
            config_name=self.cfg["model_class"], target_variables=[self.cfg["target"]],
            n_iter=int(n_iter or self.cfg["hpo_iter"]), config_path=str(self.ctx.space_path),
            val_size=float(tp["val_size"]), early_stop_patience=int(tp["early_stop_patience"]),
            seed=int(tp["tuner_seed"]), device=self.device, batch_ask=int(tp["trials_per_round"]),
            pipeline_ask=bool(tp["pipeline_ask"]))
        if epochs is not None:
            tuner.space.dimensions = [Categorical([epochs], name="epochs") if d.name == "epochs"
                                      else d for d in tuner.space.dimensions]
        with self.tracer.span("job", sync=True):
            model, best = tuner.perform_tuning(hpo_patience=int(tp["hpo_patience"]))
        self.tracer.counters["jobs"] += 1
        return model, best

    # ------------------------------------------------------------ hooks

    def _install(self):
        from flexynesis_torch.kernels import mmd
        from flexynesis_torch.models import base
        from flexynesis_torch.ops import mlp
        from flexynesis_torch.parallel import stacked, trials
        from flexynesis_torch.train import gp, hpo, trainer

        h, tr = self.hooks, self.tracer
        P = self._params_of

        def init(orig):
            def wrapped(model, seed=42):
                out = orig(model, seed)
                if self.capture:
                    start = seeded_start(model.module, self.mm, self.ctx.seed, seed,
                                         self.device)
                    model.module.load_state_dict(start, strict=False)
                    self.starts[(id(model.module), int(seed))] = start
                    self.last_start[id(model.module)] = start
                return out
            return wrapped

        h.wrap(base.BaseModel, "init_params", init)

        def group(orig):
            def wrapped(tuner, grp):
                self.cur_params = [P(p) for p in grp]
                if self.capture and self.round_rec.owner is None:
                    self.round_rec.arch = [dict(p) for p in grp]
                with tr.span("round", sync=True):
                    out = orig(tuner, grp)
                tr.counters["rounds"] += 1
                self.cur_params = None
                return out
            return wrapped

        h.wrap(hpo.HyperparameterTuning, "_run_parallel_group", group)
        h.wrap(hpo.HyperparameterTuning, "_run_parallel_group_hetero", group)

        def objective(orig):
            def wrapped(tuner, params, full_train=False):
                self.cur_params = [P(params)]
                self.retrain_arch = dict(params)
                self.in_retrain = full_train
                with tr.span("retrain" if full_train else "objective", sync=True):
                    out = orig(tuner, params, full_train=full_train)
                self.cur_params = None
                self.in_retrain = False
                return out
            return wrapped

        h.wrap(hpo.HyperparameterTuning, "objective", objective)

        def split(orig):
            def wrapped(*args, **kw):
                rec = self.round_rec
                if self.capture and rec.owner is None and rec.val_idx is None:
                    val = np.asarray(kw["val_idx"])
                    rec.val_idx = val[0] if val.ndim == 2 else val
                return orig(*args, **kw)
            return wrapped

        h.wrap(trials.ParallelTrials, "run", split)
        h.wrap(trials, "vmapped_grid_fit", split)

        def round_step(orig):
            def wrapped(rnd, data, rows):
                rec = self.round_rec
                mine = self.capture and not rec.done and rec.owner in (None, id(rnd))
                if mine:
                    self._before_round_step(rnd, rows)
                loss = orig(rnd, data, rows)
                if mine:
                    self._after_round_step(rnd, loss)
                B = rows.shape[-1]
                tr.counters["samples"] += rnd.K * B
                tr.counters["stacked_steps"] += 1
                tr.counters["flops"] += work.train_flops(sum(self.cur_params), B)
                return loss
            return wrapped

        h.wrap(trials._Round, "train_step", round_step)

        def validate(orig):
            def wrapped(rnd, batch):
                rec = self.round_rec
                if self.capture and rec.owner == id(rnd) and rec.val is None:
                    rec.val = self._validate_at_start(orig, rnd, batch)
                with tr.span("validation"):
                    out = orig(rnd, batch)
                n_val = next(iter(batch["y"].values())).shape[-1]
                tr.counters["flops"] += work.forward_flops(sum(self.cur_params), n_val)
                return out
            return wrapped

        h.wrap(trials._Round, "validate", validate)

        def train_epoch(orig):
            def wrapped(trn, perm, data, generator):
                rec = self.retrain_rec
                if self.capture and rec.owner is None and self.in_retrain:
                    rec.owner = id(trn)
                    rec.rows = [perm[s].clone() for s in range(STEPS)]
                return orig(trn, perm, data, generator)
            return wrapped

        h.wrap(trainer.Trainer, "train_epoch", train_epoch)

        def train_step(orig):
            def wrapped(trn, batch, generator):
                rec = self.retrain_rec
                mine = self.capture and rec.owner == id(trn) and not rec.done
                if mine:
                    self._before_retrain_step(trn)
                loss = orig(trn, batch, generator)
                if mine:
                    self._after_retrain_step(trn, loss)
                B = next(iter(batch["x"].values())).shape[0]
                tr.counters["samples"] += B
                tr.counters["retrain_steps"] += 1
                tr.counters["flops"] += work.train_flops(sum(self.cur_params), B)
                return loss
            return wrapped

        h.wrap(trainer.Trainer, "train_step", train_step)

        def ask(name):
            def make(orig):
                def wrapped(*a, **kw):
                    with tr.span(name):
                        return orig(*a, **kw)
                return wrapped
            return make

        h.wrap(gp.AskSession, "finish", ask("ask"))
        h.wrap(gp.AskSession, "work", ask("ask.pipelined"))

        # while a capture is open the program draws its noise from the
        # benchmark's generators, and the benchmark keeps what it handed over
        def keep_draw(orig):     # dropout(x, rate, generator)
            def wrapped(x, rate, generator):
                if self._draws is None:
                    return orig(x, rate, generator)
                g, state = self._noise_gen(generator.device)
                out = orig(x, rate, g)
                self._replay("keep", state, g.device, tuple(x.shape))
                return out
            return wrapped

        def normal_draw(orig):   # standard_normal(shape, generator, device)
            def wrapped(shape, generator, device):
                if self._draws is None:
                    return orig(shape, generator, device)
                g, state = self._noise_gen(generator.device)
                out = orig(shape, g, device)
                self._replay("normal", state, g.device, tuple(shape))
                return out
            return wrapped

        # the single model's dropout and noise, and the stacked rounds' noise
        # (a round's dropout is TrialNoise's own, wrapped per captured step);
        # the class module names what its model draws elsewhere
        draw = {"keep": keep_draw, "normal": normal_draw}
        for owner, name, kind in [(mlp, "dropout", "keep"), (stacked, "standard_normal", "normal"),
                                  *self.mm.noise_sites()]:
            h.wrap(owner, name, draw[kind])

        # kernel calls, with their shapes, in the profiled job
        def kernel(key, shapes):
            def make(orig):
                def wrapped(*a, **kw):
                    if self.record_kernels:
                        self.kernel_calls[key].append(shapes(*a))
                    return orig(*a, **kw)
                return wrapped
            return make

        def mmd_shapes(symbol, x, y):
            K = y.shape[0] if y.dim() == 3 else 1
            return symbol, K, x.shape[-2], y.shape[-2], y.shape[-1], x.dim() == 3

        h.wrap(mmd, "_launch", kernel("b3", mmd_shapes))

    def _params_of(self, params: dict) -> int:
        return work.matmul_params(self.mm.matmul_shapes(params, list(self.input_dims.values()),
                                                        int(self.cfg["n_classes"]),
                                                        dataset=self.train_ds))

    def close(self):
        self.hooks.restore()

    # ------------------------------------------------------------ noise

    def _noise_gen(self, device) -> tuple:
        """(the benchmark's generator on ``device``, its state before the
        draw the program is about to make)."""
        key = str(device)
        if key not in self._gens:
            make = (lambda: torch.Generator(device=device))
            g, twin = make(), make()
            g.manual_seed(_mix(self.ctx.seed, 0x6E6F697365, len(self._gens)))
            self._gens[key] = (g, twin)
        g = self._gens[key][0]
        return g, g.get_state()

    def _replay(self, kind: str, state, device, shape: tuple) -> None:
        """The draw the program just made from the benchmark's generator,
        made again from ``state``: uniforms for a keep mask, normals."""
        twin = self._gens[str(device)][1]
        twin.set_state(state)
        fn = torch.rand if kind == "keep" else torch.randn
        self._draws.append((kind, fn(shape, generator=twin, device=device).to(self.device)))

    # ---------------------------------------------------------- capture

    def _before_round_step(self, rnd, rows):
        rec = self.round_rec
        if rec.owner is None:
            rec.owner = id(rnd)
            rec.seeds = list(rnd.seeds)
            rec.start = [self.starts[(id(rnd.model.module), s)] for s in rec.seeds]
            rec.init = _clone(rnd.params)
            rec.init_buffers = _clone(rnd.buffers)
            rec.names = list(rnd.stacked.leaf_names)
        rec.rows.append(rows.clone())
        self._draws = []
        noise = rnd.noise
        self._program_gen = noise.generator
        noise.generator, _ = self._noise_gen(noise.generator.device)
        program_dropout = type(noise).dropout.__get__(noise)

        def dropout(h, rate):
            g, state = self._noise_gen(noise.generator.device)
            out = program_dropout(h, rate)
            self._replay("keep", state, g.device, noise._shape(h.shape))
            return out
        noise.dropout = dropout

    def _after_round_step(self, rnd, loss):
        rec = self.round_rec
        del rnd.noise.dropout
        rnd.noise.generator = self._program_gen
        rec.noise.append(self._draws)
        self._draws = None
        rec.losses.append(loss.detach().clone())
        rec.step += 1
        if rec.step == 1:
            m = rnd.opt_state.m
            rec.first_m = {n: t.detach().float().clone() for n, t in zip(rec.names, m)}
        if rec.step == STEPS:
            rec.after = _clone(rnd.params)
            rec.after_buffers = _clone(rnd.buffers)
            rec.done = True

    def _before_retrain_step(self, trn):
        rec = self.retrain_rec
        if rec.step == 0:
            rec.init = _clone(trn.module.state_dict())
            rec.start = [self.last_start[id(trn.module)]]
            rec.names = list(trn.param_names)
            rec.arch = [dict(self.retrain_arch)]
        self._draws = []

    def _after_retrain_step(self, trn, loss):
        rec = self.retrain_rec
        rec.noise.append(self._draws)
        self._draws = None
        rec.losses.append(loss.detach().reshape(1).clone())
        rec.step += 1
        if rec.step == 1:
            rec.first_m = {n: t.detach().float().clone()
                           for n, t in zip(rec.names, trn.optimizer.mu)}
        if rec.step == STEPS:
            rec.after = _clone(trn.module.state_dict())
            rec.done = True

    def _validate_at_start(self, orig, rnd, batch) -> dict:
        """The round's validation (``orig``, the program's own) once more, on
        this round's start and the benchmark's noise, the trained state put
        back afterwards; the reference works out the same from its own start."""
        rec = self.round_rec
        trained = (_clone(rnd.params), _clone(rnd.buffers))
        _copy_into(rnd.params, rec.init)
        _copy_into(rnd.buffers, rec.init_buffers)
        self._draws = []
        try:
            out = orig(rnd, batch).clone()
        finally:
            _copy_into(rnd.params, trained[0])
            _copy_into(rnd.buffers, trained[1])
            draws, self._draws = self._draws, None
        return {"out": out, "draws": draws}

    # ----------------------------------------------------------- window

    def window(self, seconds: float) -> dict:
        """Jobs back to back until ``seconds`` have passed; the first is
        captured for the reference."""
        tr = self.tracer
        sync = torch.cuda.synchronize if self.device.type == "cuda" else (lambda: None)
        sync()
        t0 = time.perf_counter()
        ends = []
        while True:
            self.capture = not ends
            self.job()
            self.capture = False
            self.starts.clear()
            self.last_start.clear()
            sync()
            ends.append(time.perf_counter() - t0)
            if ends[-1] >= seconds:
                break
        c = tr.counters
        return {"seconds": ends[-1], "jobs": len(ends), "samples": c["samples"],
                "flops": c["flops"], "attempted": len(ends), "failed": 0,
                "job_s": list(np.diff([0.0] + ends))}

    def profiled(self) -> dict:
        """One more job under the device profiler, its kernel calls recorded."""
        for calls in self.kernel_calls.values():
            calls.clear()
        self.record_kernels = True
        with Profiled(self.tracer) as prof:
            self.job()
        self.record_kernels = False
        return prof.summary

    def kernel_least_seconds(self) -> Dict[str, float]:
        """Each kernel's least time over the calls the profiled job made."""
        b3 = [work.b3_term_work(K, N, M, d, per) if sym == "mmd_term_f32"
              else work.b3_mean_work(N, M, d)
              for sym, K, N, M, d, per in self.kernel_calls["b3"]]
        return {"b3": work.total_least(b3)} if b3 else {}

    # ------------------------------------------------------- reference

    def _data(self, split_rows) -> tuple:
        x = {ln: v[split_rows] for ln, v in self.cohort.x.items()}
        return x, self.cohort.y[split_rows]

    def _ref_start(self, rec, k: int, stacked: bool) -> tuple:
        """(parameters, running statistics, bfloat16 leaves) of trial k's
        start as the reference works it out from the benchmark's draw at the
        round's widths: cut to the trial's own widths, rescaled to their
        initialisation law (``reference/init.py``), and, where the
        configuration stores a leaf in bfloat16 (at least ``sr_min_size``
        elements per trial), rounded to it to nearest, as the start is cast."""
        mm = self.mm
        w = mm.widths(rec.arch[k if stacked else 0], self.input_dims)
        full, own = {}, {}
        for n, t in rec.start[k if stacked else 0].items():
            name = mm.canon(n)
            full[name] = t
            own[name] = adapt.trial_leaf(mm, name, full[name], w)
        size = int(self.cfg["sr_min_size"])
        bf16 = {n for n, t in full.items() if t.numel() >= size} if stacked else set()
        params, stats = {}, {}
        for name, t in own.items():
            kind = mm.init_law(name)
            if kind in ("torch", "xavier"):
                wn = ref_init.weight_of(name)
                f = ref_init.scale(name, kind, tuple(full[wn].shape), tuple(own[wn].shape))
                t = t * torch.tensor(f, dtype=torch.float32, device=t.device)
            if name in bf16:
                t = t.to(torch.bfloat16).float()
            (stats if name.endswith((".rm", ".rv")) else params)[name] = t
        return params, stats, bf16

    @staticmethod
    def _draw_of(rec, k: int) -> int:
        """Trial k's draw among a stacked round's per-draw noise: trials
        that share a seed share one (the first of each seed in order)."""
        first: Dict[int, int] = {}
        return [first.setdefault(int(s), len(first)) for s in rec.seeds][k]

    def _keeps(self, rec, draws, k, w, stacked):
        """Trial k's noise: its share of each draw; a keep mask is the
        benchmark's uniforms at or above its block's rate, cut to the trial's
        width. A stacked round's training step (``stacked``) draws once per
        distinct seed, with a leading draw axis, unless its trials share one
        seed (``TrialNoise.shared``); its validation and the retrain draw
        without one."""
        per_draw = stacked and len({int(s) for s in rec.seeds}) > 1
        blocks = iter(self.mm.noise_blocks(self.layers, self.cfg["target"], self.cfg, w))
        out = []
        for kind, t in draws:
            if per_draw:
                t = t[self._draw_of(rec, k)]
            if kind == "keep":
                block, rate = next(blocks)
                t = adapt.trial_keep(self.mm, block, t >= rate, w)
            out.append((kind, t.float()))
        return out

    def _follow(self, rec, k, stacked, control, gen_seed, fault=None, dtype=torch.float32) -> dict:
        """The reference's readings of trial k of a captured stretch: its
        start, step losses, first-gradient and three-step change norms per
        leaf."""
        cfg = self.cfg
        arch = rec.arch[k if stacked else 0]
        w = self.mm.widths(arch, self.input_dims)
        p0, s0, bf16 = self._ref_start(rec, k, stacked)
        start = {**p0, **s0}
        p0 = {n: t.to(dtype) for n, t in p0.items()}
        s0 = {n: t.to(dtype) for n, t in s0.items()}
        gen = torch.Generator(device=self.device)
        gen.manual_seed(gen_seed)
        lr = float(np.float32(arch["lr"])) if stacked else float(arch["lr"])
        opt = ref_adam.Adam(p0, lr, cfg, bf16=bf16, generator=gen, dtype=dtype)
        p, s, losses = p0, dict(s0), []
        with tf32(control):
            for step in range(STEPS):
                rows = rec.rows[step]
                rows = rows[k] if rows.dim() == 2 else rows
                draws = self._keeps(rec, rec.noise[step], k, w, stacked)
                if fault == "half":   # the planted fault: half the batch, the mean over the rest
                    B, half = rows.shape[0], rows.shape[0] // 2
                    rows = rows[:half]
                    draws = [(kind, t[:half] if t.shape[0] == B else t) for kind, t in draws]
                x, y = self._data(rows.to(self.cohort.y.device))
                x = {n: t.to(dtype) for n, t in x.items()}
                draws = [(kind, t.to(dtype)) for kind, t in draws]
                loss, grads = self.mm.train_loss_and_grads(
                    p, s, x, y, self.layers, cfg["target"], draws, cfg)
                stepped = opt.step(p, grads)
                if fault != "stale":   # the planted fault: a step that keeps its state
                    p = stepped
                losses.append(loss)
                if step == 0:
                    grad = {n: opt.first_gradient(n) for n in p}
        change = {n: p[n] - p0[n] for n in p}
        change.update({n: s[n] - s0[n] for n in s})
        return {"start": start, "loss": losses, "grad": norms(grad), "change": norms(change),
                "params": list(p)}

    def _program(self, rec, k, stacked) -> dict:
        """The program's readings of trial k, as ``_follow`` gives the
        reference's, each leaf cut to the trial's own widths; ``padding``
        counts the nonzero entries of its parameters and first moments
        outside them, which a padded trial keeps at exactly zero."""
        b1 = float(self.cfg["adam"]["b1"])
        mm = self.mm
        w = mm.widths(rec.arch[k if stacked else 0], self.input_dims)
        padding = 0

        def own(n, t, flax_layout=False, count=True):
            nonlocal padding
            name = mm.canon(n)
            t = (t[k] if stacked else t).float()
            if flax_layout and t.dim() == 2:   # the optimizer's layout: weights are (in, out)
                t = t.T
            mine = adapt.trial_leaf(mm, name, t, w)
            if count and not name.endswith((".rm", ".rv")):
                padding += int(torch.count_nonzero(t)) - int(torch.count_nonzero(mine))
            return name, mine

        start = dict(own(n, t, count=False) for tree in (rec.init, rec.init_buffers)
                     for n, t in tree.items() if mm.canon(n) is not None)
        grad = dict(own(n, t / (1 - b1), flax_layout=stacked) for n, t in rec.first_m.items())
        change = {}
        for before, after in ((rec.init, rec.after), (rec.init_buffers, rec.after_buffers)):
            for n, t in before.items():
                if mm.canon(n) is not None and n in after:
                    name, new = own(n, after[n])
                    change[name] = new - own(n, t, count=False)[1]
        losses = [float(l.reshape(-1)[k] if stacked else l.reshape(-1)[0]) for l in rec.losses]
        return {"start": start, "loss": losses, "grad": norms(grad), "change": norms(change),
                "padding": padding}

    def _val_reading(self, k, control, fault=None) -> float:
        """The reference's validation loss of trial k at its start, on the
        benchmark's noise."""
        rec, cfg = self.round_rec, self.cfg
        w = self.mm.widths(rec.arch[k], self.input_dims)
        p, s, _ = self._ref_start(rec, k, True)
        rows = torch.as_tensor(rec.val_idx, device=self.cohort.y.device)
        if fault == "half":
            rows = rows[: rows.shape[0] // 2]
        x, y = self._data(rows)
        draws = self._keeps(rec, rec.val["draws"], k, w, False)
        with tf32(control):
            return self.mm.eval_loss(p, s, x, y, self.layers, cfg["target"], draws, cfg)

    def witness(self) -> dict:
        """The round and the retrain followed by the reference in float64: a
        second witness of how far rounding alone parts two float32 runs."""
        rnd = self.round_rec
        return {"round": [self._follow(rnd, k, True, False, 0, dtype=torch.float64)
                          for k in range(len(rnd.arch))],
                "retrain": self._follow(self.retrain_rec, 0, False, False, 0,
                                        dtype=torch.float64)}

    def readings(self, control: bool = False, seed_shift: int = 0, fault=None) -> dict:
        """The reference's readings of every captured stretch (``control``:
        computed with TF32 products)."""
        rnd, ret = self.round_rec, self.retrain_rec
        if not (rnd.done and ret.done and rnd.val is not None):
            raise RuntimeError("the window's first job left no complete capture")
        base = 7919 * (int(self.ctx.seed) % 1000003) + seed_shift
        K = len(rnd.arch)
        return {"round": [self._follow(rnd, k, True, control, base + k, fault) for k in range(K)],
                "val": [self._val_reading(k, control, fault) for k in range(K)],
                "retrain": self._follow(ret, 0, False, control, base + K, fault)}

    def program_readings(self) -> dict:
        rnd, ret = self.round_rec, self.retrain_rec
        K = len(rnd.arch)
        return {"round": [self._program(rnd, k, True) for k in range(K)],
                "val": [float(v) for v in rnd.val["out"].reshape(-1)],
                "retrain": self._program(ret, 0, False)}

    @staticmethod
    def _live(r) -> list:
        return live_leaves({n: r["grad"][n] for n in r["params"]})

    @classmethod
    def _changed(cls, r) -> list:
        # parameters, and running variances; a running mean follows the
        # pre-BatchNorm bias, whose gradient is nought to rounding
        return cls._live(r) + [n for n in r["change"] if n.endswith(".rv")]

    @classmethod
    def retrain_gaps(cls, g: dict, r: dict, details: bool = False) -> Dict[str, float]:
        """The retrain's numbers: its first step's loss, and the median
        leaf's first gradient and three-step change."""
        grads = leaf_gaps(g["grad"], r["grad"], cls._live(r))
        changes = leaf_gaps(g["change"], r["change"], cls._changed(r))
        out = {"retrain.start": start_gap(g["start"], r["start"]),
               "retrain.loss1": rel_gap(g["loss"][:1], r["loss"][:1]),
               "retrain.grad_med": median(list(grads.values())),
               "retrain.change_med": median(list(changes.values()))}
        if details:
            gw, cw = max(grads, key=grads.get), max(changes, key=changes.get)
            out.update({"x.retrain.loss_by_step": [rel_gap(a, b) for a, b in
                                                   zip(g["loss"], r["loss"])],
                        "x.retrain.grad_worst": grads[gw], "x.retrain.grad_worst_leaf": gw,
                        "x.retrain.change_worst": changes[cw],
                        "x.retrain.change_worst_leaf": cw})
        return out

    @classmethod
    def round_grad_gaps(cls, got: list, ref: list, details: bool = False) -> Dict[str, object]:
        """The round's first gradient: the median over trials of each
        trial's median leaf gap. A ReLU input within rounding of zero, which
        one float32 run puts on the other side, moves one trial's leaf, and
        under the global-norm clip every other leaf of that trial with it;
        the median over trials is not moved by that. ``details`` adds the
        largest trial's median, the worst leaf's gap, its trial and leaf,
        and every trial's median."""
        per = [leaf_gaps(g["grad"], r["grad"], cls._live(r)) for g, r in zip(got, ref)]
        meds = [median(list(p.values())) for p in per]
        out = {"round.grad_med": median(meds)}
        if details:
            out["x.round.grad_med_max"] = max(meds)
            k = max(range(len(per)), key=lambda i: max(per[i].values()))
            leaf = max(per[k], key=per[k].get)
            out.update({"x.round.grad_worst": per[k][leaf], "x.round.grad_worst_at": [k, leaf],
                        "x.round.grad_med_by_trial": meds})
        return out

    @classmethod
    def gaps(cls, got: dict, ref: dict, details: bool = False) -> Dict[str, float]:
        """The compared numbers: ``got``'s readings against the reference's.

        Each side works out every trial's start from the benchmark's draw
        (``round.start``, ``retrain.start``: equal entry for entry), so the
        round's first step and its validation (``round.val``, at the start)
        begin from one state on both sides; its
        later steps from states that the stochastic rounding parted, each
        side with its own bits: their loss is compared by the median trial
        (a trial at a large lr parts two references that differ only in
        those bits by up to 5%), and the worst leaf's change by a limit
        above that rounding's floor. The first gradient, of the round (by
        the median over trials of each trial's median leaf) and of the
        retrain (float32, no rounding to bfloat16), is compared by the
        median leaf, and the retrain also on its first
        step's loss and on the median leaf's change: its later steps and
        the worst leaf of either move with the ReLU and LeakyReLU units
        whose pre-activation lies within rounding of zero in some row, which
        part two float32 runs on a few seeds in thirty (``details`` gives
        those readings; PERF.md has them and the float64 witness)."""
        rounds = list(zip(got["round"], ref["round"]))
        out = {
            "round.start": max(start_gap(g["start"], r["start"]) for g, r in rounds),
            "round.loss1": max(rel_gap(g["loss"][:1], r["loss"][:1]) for g, r in rounds),
            "round.loss23_med": median([rel_gap(g["loss"][1:], r["loss"][1:])
                                        for g, r in rounds]),
            **cls.round_grad_gaps(got["round"], ref["round"], details),
            "round.change": max(worst_leaf(g["change"], r["change"], cls._changed(r))
                                for g, r in rounds),
            "round.val": rel_gap(got["val"], ref["val"]),
        }
        out.update(cls.retrain_gaps(got["retrain"], ref["retrain"], details))
        if details:
            later = [rel_gap(g["loss"][1:], r["loss"][1:]) for g, r in rounds]
            out.update({"x.round.loss23_by_trial": later, "x.round.loss23_max": max(later)})
        if "padding" in got["retrain"]:   # the program's readings only
            out["round.padding"] = float(max(g["padding"] for g, _ in rounds))
        return out


TRAFFIC = Tune
