"""Drive flexynesis_torch on one CUDA card and check it end to end.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure exits nonzero):
1. the card's name and power limit; build kernels B1, B2 and B3 with nvcc
   for sm_90a and the CSV reader (``csrc/fastcsv.cpp``) with g++, one
   compiler per source, started together;
2. kernel B2 (eval-mode fused Linear->BN->ReLU) against its plain PyTorch
   version at the three calls of one eval forward at each batch size its
   paths give it (the 2000-sample cohort, a 64-row request, the 400-row
   validation split and the 500-row test cohort), at every cluster size its
   planner picks, an F and H that take 4-byte copies, one row, a ragged shape
   and the production single-model encoder: one launch per call, two calls
   bit for bit; CUDA-event, profiler device and host-issue times of the
   kernel, the plain version's time, torch.addmm's (a GEMM-only yardstick)
   event and device times, and the bound of each shape by the route of the
   kernel's main loop (3xTF32 on the tensor cores) beside the f32 bound; then
   the same summed over each eval forward;
3. kernel B1 (training-mode, batch statistics) the same way at every shape
   the training phase launches, F deep enough for every cluster size the
   planner picks, an F and H that take 4-byte copies, 32- and 128-row
   batches, a ragged shape, B = 1 and a 4096-row batch (the split
   reduction), two calls bit for bit; its gradients (kernel forward + the JAX
   backward formula) against autograd through the plain version at the three
   training shapes;
3b. kernel B3 (the Gaussian-kernel means of the VAE-MMD loss): one mean at
   the shapes of the MMD's three means on the VAE's path (a 200-draw prior
   against a 64-row batch and a 400-row validation split, latent 64), a
   ragged shape, one row, latent 128 and a 4096 x 4096 grid of 4096 blocks:
   the mean within 1e-6 / rtol 1e-5 of the plain version, two calls bit for
   bit, and at the training shapes the gradients of the kernel mean (also of
   y against itself) and of the MMD term against autograd through the plain
   version; then the whole MMD term in one launch (the VAE's call) at the
   training and validation shapes, a ragged shape and one row: its three
   means and the MMD against the plain version, two calls bit for bit, and
   its gradients at the training shape;
4. serving at full width: the DirectPred headline configuration (gex 2000 and
   cnv 1000 features, hidden widths 600 and 300, latent 64, supervisor hidden
   16, 4 classes, fused_kernels on) scores a 2000-sample cohort through
   ``python -m flexynesis_torch``'s inference mode on the card, once more on
   the CPU as the reference, then answers timed requests;
5. training at full width: ``python -m flexynesis_torch`` in training mode on
   the card (feature selection down to gex 2000 and cnv 1000, one HPO trial,
   10 epochs of batch 64) with B1 in every training step and B2 in validation
   and evaluation, checked by launch counts; the saved model is served by the
   inference CLI on the card and on the CPU, and the two agree; three steps
   from one initialisation agree between the card and the CPU; step time,
   samples/s and a profiled epoch; then B2 against its plain version at the
   batch sizes the training run gave it (validation split, train and test
   cohorts) that serving did not;
6. supervised_vae at the same width (encoders 2000->600 and 1000->300,
   decoders 64->600->2000 and 64->300->1000, latent 64, head 16,
   fused_kernels on) through the training CLI on the card, on the folder of
   phase 5, one trial of 10 epochs of batch 64, marker finding on (both
   methods): B3 in every training step and validation, B1 and B2 in none,
   checked by launch counts; the loss falls; each importance table holds the
   target's classes over every input feature, finite, >= 0, positive in sum;
   the saved model served with marker finding on the card and on the CPU
   agrees, importance tables too; three steps agree between the card and the
   CPU (eps and prior from one CPU generator); step time and a profiled run
   of steps;
7. CrossModalPred, gex encoded and cnv decoded, 3 epochs, marker finding on
   (gex only, its input layer): B3's launch counts, the importance tables,
   ``fit.cnv_decoded.csv`` with 500 x 1000 values in [0, 1], and the saved
   model (with its decoded layer and its importances) served on the card and
   on the CPU agree;
8. the K-stacked HPO trial engine (after phase 5, on its folder and
   import): B1 and B2 with a trial axis against their plain versions (with
   phase 3) at K = 16 over the three blocks (B1's batch rows shared and per
   trial, B2 over the 400-row validation split), K = 1 (the same bits as
   without the axis) and a ragged K = 3, one launch per stacked call, B1's
   gradients; three stacked steps of K = 4 (f32 parameters and moments,
   four lrs) against four single-trial Trainer steps and against the CPU;
   SR-bf16 Adam on the card against the CPU (the engine's optimizer, with
   fixed SR seeds): three Adam steps on the same gradients bit for bit,
   clipped and unclipped, and three SR-bf16 stacked steps of a
   same-architecture round and of a padded mixed round (element masks,
   padded entries exactly zero); one stacked step's time and a profiled
   run; then three training CLI runs of 16 suggestions: a
   same-architecture round (``--hpo_batch 0`` must resolve to 16, ``lr``
   free) whose B1 and B2 launches grow with the steps
   and not with K and whose retrained model serves alike on the card and
   the CPU, the same 16 trials one at a time (``--hpo_batch 1``), and a
   mixed-architecture round (the default space, fused off) that must take
   the padded path and retrain its best; trials/h of each;
8b. the VAE-MMD trial engine and the CV fold engine (after phase 8): B3
   with a trial axis against its plain version (with phase 3: the 16-trial
   training and 400-row validation terms, the prior shared and per trial,
   K = 1, a ragged K = 3; one launch per call, every trial bit for bit equal
   to a one-trial call on its slice, the gradients); three stacked
   supervised_vae steps of K = 16 (f32, fused) against 16 single-trial
   Trainer steps on the card and against the CPU; a padded supervised_vae
   round (masks and ``_aux``: the masked MMD, B3 never) and one CV step of
   4 x 5 trials (each its fold's rows and its own prior) on the card against
   the CPU; one stacked VAE step's time and profile; then five training CLI
   runs: a supervised_vae round of 16 suggestions (``--hpo_batch 0`` must
   resolve to 16, lr free, fused: B3 once per decoded layer per stacked step
   and validation and per retrain step), the same 16 one at a time, a
   default-space CrossModalPred round (fused, padded: B3 only in the final
   retrain), and ``--use_cv`` rounds of 4 suggestions x 5 folds = 20 trials
   of DirectPred (fused: B1 and B2 with per-trial x) and supervised_vae
   (fused: B3 with a per-trial prior), each checked by launch counts, with
   trials/h and the card's peak allocated memory;
9. marker finding and the CSV reader, on phase 5's folder: its raw matrices
   read by the native reader and by the Python reader in one process (the
   seconds of each; the matrices equal, or each differing cell printed with
   its text and the native value its correctly rounded float32); a default
   DirectPred (fused_kernels off, as in the JAX package) through the training
   CLI on the card with both methods (IntegratedGradients and GradientShap),
   B1, B2 and B3 launched no time, each importance table checked as in phase
   6; the saved model served with marker finding on the card and on the CPU,
   the tables within rtol 1e-4 / atol 1e-6; the seconds of each method on the
   card over the 500-sample test cohort and over the 2000 training samples
   as a cohort, with a profiled run; a fused DirectPred with marker finding
   on exits nonzero with the port's refusal, in training and in inference.
   The fused phases 4, 5 and 8 run with ``--disable_marker_finding``;
10. the model zoo, where no kernel of the port lies (B1, B2 and B3 must
   launch no time on any of these paths): MultiTripletNetwork at the
   headline width on phase 5's folder (``fused_kernels`` true, which the
   triplet model ignores as in JAX), one trial of 10 epochs through the
   training CLI with marker finding, served with marker finding on the card
   and on the CPU (outputs and tables agree), three steps card against CPU,
   the step time, three stacked steps of K = 4 against Trainer steps and the
   CPU, the stacked step's time at K = 16, then CLI rounds of 16 suggestions
   batched (lr free) and one at a time, a padded mixed round of the default
   space and a ``--use_cv`` round of 4 x 5; then the GNN on a folder whose
   gex and cnv rows share gene names (4000 and the first 2000 of them,
   selected to 2000 and 1000) with a user graph (a ring plus two random
   edges per gene): GC convs over about 2,500 nodes, one trial of 10 epochs
   through the CLI with marker finding, served on the card and the CPU
   (attribution capped at 4 samples), three steps card against CPU for each
   conv type (GAT with the sparse operator), the step time, dense against
   sparse at that node count (GC and GAT: outputs, loss and gradients, step
   times and peak memory), stacked steps against Trainer steps and the CPU,
   the stacked step's time, CLI rounds of 16 batched and one at a time and a
   mixed round of the default space (buckets by ``num_convs``), and STRING
   scale at 10,000 nodes at the model level (``gnn_sparse: "auto"`` takes
   the edge list; steps and the eval forward card against CPU; dense
   against sparse there).

(The port groups supervised_vae suggestions by architecture identity, as
the JAX tuner does: its class name ``SupervisedVAE`` is not the
``"supervised_vae"`` of JAX's ``PADDABLE_MODELS``, so a default-space
supervised_vae round trains its sampled architectures one at a time in both
packages. Phase 8b takes the padded VAE path through CrossModalPred's CLI
round and through supervised_vae's padded round of stacked steps.)

Every kernel check prints the kernel's CUDA-event time per call, beside its
device time per call from a torch.profiler trace (``device_ms``), the plain
version's time and the bound; the profiled serving and training runs name
each port kernel's CUDA function with its device time. Each kernel's launch count is set to 0 just
before the phase that drives its path (serving for B2, training for B1,
phases 6 and 7 for all three) and read just after. The output ends
with a ``{"kernels": [...]}`` line, the nvidia-smi line and
``{"ok": true, "device": {...}}``. Working files go to build/chip_smoke/.
"""

from __future__ import annotations

import json
import math
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, TF32 on
# the tensor cores (dense), HBM3
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12
TOL = dict(rtol=1e-4, atol=1e-4)  # f32, different summation orders, TF32 off

# serving configuration (bench.py:65-73)
GEX, CNV, LATENT, HIDDEN_FACTOR, SUP_HIDDEN, N_CLASSES = 2000, 1000, 64, 0.3, 16, 4
N_TEST, N_TRAIN, BATCH = 2000, 256, 64
B2_PER_FORWARD = 3  # two encoders and one head
CLI_FORWARDS = 2  # transform and predict each run one eval forward

# training configuration: raw widths that feature selection (top 50 percent,
# no variance cut) brings down to GEX and CNV
RAW_GEX, RAW_CNV, TOP_PERCENTILE, FEATURES_MIN = 4000, 2000, 50, 500
FIT_TRAIN, FIT_TEST, FIT_EPOCHS, VAL_SIZE = 2000, 500, 10, 0.2
B1_PER_STEP = 3  # two encoders and one head
EVAL_FORWARDS = 4  # transform and predict, of train and of test
PROFILED_STEPS = 7
CM_EPOCHS = 3  # the CrossModalPred run, cut to 3 epochs
TRIALS = 16  # suggestions per GP round: --hpo_batch 0 on the card, hpo_iter 16
DEVICE = "cuda"  # the training phase's device (a CPU rehearsal sets "cpu")
# the CUDA functions of the port's kernels, as the profiles name them: B1
# (and its merge launch above 64 rows), B2 and B3
KERNEL_FUNCTIONS = ("fused_linear_bn_relu_train_split_kernel", "bn_relu_merge_kernel",
                    "fused_linear_bn_relu_eval_kernel", "gaussian_kernel_mean_kernel")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median device time of one call, from CUDA events around each call."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps: int = 20):
    """(device ms per call, device operations per call) of ``fn`` from a
    torch.profiler trace of ``reps`` calls: the kernels' own time on the
    card, without the host's issue of the wrapper that the CUDA events
    bracket. (None, 0) where the profiler saw no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):  # a trace now and then comes back without device events
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        total_us = sum(e.self_device_time_total for e in events)
        if total_us > 0:
            return total_us / reps / 1e3, sum(e.count for e in events) / reps
    return None, 0


def host_ms(fn, reps: int = 50) -> float:
    """Host-clock time to issue one call of ``fn`` (the wrapper's checks,
    allocations and launch), from ``reps`` calls issued back to back without
    a synchronisation: the part of a CUDA-event time that is the host's."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    issued = time.perf_counter() - t
    torch.cuda.synchronize()
    return issued / reps * 1e3


def fmt_ms(v) -> str:
    return "not measured" if v is None else f"{v:.4f} ms"


def f32_ms(flops: float) -> float:
    """Least time in ms of ``flops`` f32 operations on the FMA units."""
    return flops / PEAK_F32_FLOPS * 1e3


def bound_ms(ops_ms: float, nbytes: float):
    """The least time of a call (ms) and what sets it: its operations' least
    time against its bytes over the memory rate."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(ops_ms, t_bytes), ("operations" if ops_ms >= t_bytes else "bytes")


def work_b2(B: int, F: int, H: int):
    """(least time of the operations in ms, the same in f32, bytes) of one B2
    call. B2's main loop is 3xTF32: the product three times on the tensor
    cores (495 TFLOP/s); the f32 time is the product once on the FMA units
    (67 TFLOP/s), the bound of an FMA kernel, printed beside it. The 6-op
    epilogue per output runs on the FMA units either way. Each input read
    once and the output written once, in f32."""
    gemm, epilogue = 2 * B * F * H, 6 * B * H
    ops_ms = 3 * gemm / PEAK_TF32_FLOPS * 1e3 + f32_ms(epilogue)
    return ops_ms, f32_ms(gemm + epilogue), 4 * (B * F + F * H + 5 * H + B * H)


def check_kernel(shapes):
    """Hold B2 against its plain version at each (label, (B, F, H)): within
    TOL, one launch per call, two calls bit for bit. Times the kernel (CUDA
    events, profiler device time, host issue), the plain version and
    torch.addmm of the same GEMM (CUDA events and device time; a yardstick,
    not the same function). Returns per-shape rows."""
    import torch
    from flexynesis_torch.kernels import fused_linear

    kernel = fused_linear.fused_linear_bn_relu_eval
    plain = fused_linear.fused_linear_bn_relu_eval_ref
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for label, (B, F, H) in shapes:
        g = torch.Generator(device="cuda").manual_seed(B * 7 + F * 3 + H)
        x = torch.randn(B, F, device="cuda", generator=g)
        w = (torch.rand(F, H, device="cuda", generator=g) * 2 - 1) / math.sqrt(F)
        b, rm, be = (torch.randn(H, device="cuda", generator=g) * 0.1 for _ in range(3))
        gamma = torch.rand(H, device="cuda", generator=g) + 0.5
        rv = torch.rand(H, device="cuda", generator=g) + 0.5
        args = (x, w, b, gamma, be, rm, rv)
        before = kernel.launches
        y = kernel(*args)
        torch.cuda.synchronize()
        if kernel.launches != before + 1:
            fail(f"B2 made {kernel.launches - before} launches at {label}")
        ref = plain(*args)
        diff = (y - ref).abs()
        max_abs = diff.max().item()
        max_rel = max_abs / ref.abs().max().item()  # normwise: against the largest output
        if not torch.allclose(y, ref, **TOL):
            fail(f"B2 disagrees with its plain version at {label} B={B} F={F} H={H}: "
                 f"max abs {max_abs:.3e}, max rel {max_rel:.3e}, tolerance {TOL}")
        if not torch.equal(y, kernel(*args)):
            fail(f"B2 is not deterministic at {label}")
        reps = 10 if B * F * H > 1e10 else 30
        ms = cuda_ms(lambda: kernel(*args), reps)
        dev_ms, dev_ops = device_ms(lambda: kernel(*args), reps)
        issue_ms = host_ms(lambda: kernel(*args))
        plain_ms = cuda_ms(lambda: plain(*args), reps)
        addmm_ms = cuda_ms(lambda: torch.addmm(b, x, w), reps)
        addmm_dev, _ = device_ms(lambda: torch.addmm(b, x, w), reps)
        ops_ms, f32_ops_ms, nbytes = work_b2(B, F, H)
        bms, by = bound_ms(ops_ms, nbytes)
        f32_bms = bound_ms(f32_ops_ms, nbytes)[0]
        flops = 2 * B * F * H + 6 * B * H
        plan = fused_linear.plan_b2(B, F, H, sms)
        rows.append(dict(label=label, B=B, F=F, H=H, split=plan.split, ctas=plan.ctas,
                         max_abs_err=max_abs, max_rel_err=max_rel, ms=ms, device_ms=dev_ms,
                         host_ms=issue_ms, plain_ms=plain_ms, addmm_ms=addmm_ms,
                         addmm_device_ms=addmm_dev, flops=flops, bytes=nbytes, ops_ms=ops_ms,
                         f32_ops_ms=f32_ops_ms))
        print(f"B2 {label:>16} B={B:5d} F={F:6d} H={H:5d} (cluster {plan.split}, "
              f"{plan.ctas} CTAs)  max_abs_err={max_abs:.3e} normwise_rel_err={max_rel:.3e} "
              f"(tol {TOL}) deterministic, 1 launch  kernel {ms:.4f} ms (device "
              f"{fmt_ms(dev_ms)}, {dev_ops:g} device ops; host issue {issue_ms:.4f} ms)  "
              f"plain {plain_ms:.4f} ms  addmm(GEMM only) {addmm_ms:.4f} ms (device "
              f"{fmt_ms(addmm_dev)})  bound {bms:.4f} ms (3xTF32, {by}; f32 bound "
              f"{f32_bms:.4f} ms)  {flops / ms / 1e9:.2f} TFLOP/s", flush=True)
    return rows


def b2_blocks():
    """(name, (F, H)) of the three B2 calls of one DirectPred eval forward."""
    return [("encoder_gex", (GEX, int(GEX * HIDDEN_FACTOR))),
            ("encoder_cnv", (CNV, int(CNV * HIDDEN_FACTOR))),
            ("head_subtype", (LATENT, SUP_HIDDEN))]


def b2_pass_rows():
    """(pass, rows) of one eval forward at each batch size the paths give B2:
    the served cohort, a 64-row request (serving's ``predict batch64``), the
    validation split and the test cohort of the training phase."""
    return [("cohort", N_TEST), ("request", BATCH),
            ("validation", int(math.ceil(FIT_TRAIN * VAL_SIZE))), ("test", FIT_TEST)]


def b2_passes(rows):
    """Each pass of ``b2_pass_rows`` summed over its three calls: the three
    timings, the plain version and addmm; the pass's printed line adds the
    3xTF32 bound and the f32 bound."""
    blocks = [fh for _, fh in b2_blocks()]
    passes = {}
    for name, n in b2_pass_rows():
        by_shape = {(r["F"], r["H"]): r for r in rows if r["B"] == n}
        sel = [by_shape[fh] for fh in blocks if fh in by_shape]
        if len(sel) != len(blocks):
            continue
        total = {k: sum(r[k] for r in sel)
                 for k in ("ms", "host_ms", "plain_ms", "addmm_ms", "ops_ms", "f32_ops_ms",
                           "bytes")}
        for k in ("device_ms", "addmm_device_ms"):
            total[k] = None if any(r[k] is None for r in sel) else sum(r[k] for r in sel)
        bms, by = bound_ms(total["ops_ms"], total["bytes"])
        f32_bms = bound_ms(total["f32_ops_ms"], total["bytes"])[0]
        passes[name] = dict(rows=n, ms=total["ms"], device_ms=total["device_ms"],
                            host_ms=total["host_ms"], plain_ms=total["plain_ms"],
                            addmm_ms=total["addmm_ms"],
                            addmm_device_ms=total["addmm_device_ms"])
        print(f"B2 pass {name} ({n} rows, {len(sel)} calls): device {fmt_ms(total['device_ms'])}"
              f"  CUDA events {total['ms']:.4f} ms  host issue {total['host_ms']:.4f} ms  "
              f"bound {bms:.4f} ms (3xTF32, {by})  f32 bound {f32_bms:.4f} ms  plain "
              f"{total['plain_ms']:.4f} ms  addmm(GEMM only) {total['addmm_ms']:.4f} ms (device "
              f"{fmt_ms(total['addmm_device_ms'])})", flush=True)
    return passes


def check_b2():
    """B2 at every pass of ``b2_pass_rows``, then one shape per cluster size
    its planner picks beyond those, an F and H that take 4-byte copies, one
    row, a ragged shape and a large single-model encoder. Returns (rows,
    passes)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    shapes, seen = [], set()
    for name, n in b2_pass_rows():
        for block, (F, H) in b2_blocks():
            if (n, F, H) not in seen:
                seen.add((n, F, H))
                shapes.append((f"{block}_n{n}", (n, F, H)))
    h_gex = int(GEX * HIDDEN_FACTOR)
    shapes += [("split2_f128", (BATCH, 128, h_gex)), ("split4_f256", (BATCH, 256, h_gex)),
               ("unaligned", (BATCH, GEX - 1, h_gex + 1)), ("one_row", (1, GEX, h_gex)),
               ("ragged", (37, 129, 67)), ("large_encoder", (1024, 16384, int(16384 * 0.3)))]
    rows = check_kernel(shapes)
    return rows, b2_passes(rows)


def b2_forward_times():
    """{pass: (host issue ms, CUDA-event ms)} of one eval forward (B2's three
    calls back to back) at each pass of ``b2_pass_rows``. It calls only the
    public wrapper, so it times whichever ``flexynesis_torch`` is imported:
    that of an earlier commit too, when two trees are compared in one call."""
    import torch
    from flexynesis_torch.kernels.fused_linear import fused_linear_bn_relu_eval as kernel

    g = torch.Generator(device="cuda").manual_seed(0)
    times = {}
    for name, n in b2_pass_rows():
        calls = []
        for _, (F, H) in b2_blocks():
            x = torch.randn(n, F, device="cuda", generator=g)
            w = torch.randn(F, H, device="cuda", generator=g) / math.sqrt(F)
            vecs = [torch.rand(H, device="cuda", generator=g) + 0.5 for _ in range(5)]
            calls.append((x, w, *vecs))

        def forward():
            for args in calls:
                kernel(*args)

        times[name] = (host_ms(forward), cuda_ms(forward, 30))
        print(f"B2 forward {name} ({n} rows): host issue {times[name][0]:.4f} ms  "
              f"CUDA events {times[name][1]:.4f} ms", flush=True)
    return times


def work_b1(B: int, F: int, H: int):
    """(FLOPs, bytes) of B1: the GEMM plus about 12 operations per output for
    the statistics and the normalisation; x and w read once, h and y written
    once, in f32."""
    return 2 * B * F * H + 12 * B * H, 4 * (B * F + F * H + 2 * B * H + 5 * H)


def check_b1(shapes, grad_shapes):
    """Hold B1 against its plain version at each shape (forward: y, h, mean,
    var) and its gradients at ``grad_shapes``; returns per-shape rows."""
    import torch
    from flexynesis_torch.kernels.fused_linear import (
        fused_linear_bn_relu,
        fused_linear_bn_relu_forward as kernel,
        fused_linear_bn_relu_ref as plain,
        plan_b1,
    )

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for label, (B, F, H) in shapes:
        plan = plan_b1(B, F, H, sms)
        g = torch.Generator(device="cuda").manual_seed(B * 5 + F * 3 + H)
        x = torch.randn(B, F, device="cuda", generator=g)
        w = (torch.rand(F, H, device="cuda", generator=g) * 2 - 1) / math.sqrt(F)
        b, be = (torch.randn(H, device="cuda", generator=g) * 0.1 for _ in range(2))
        gamma = torch.rand(H, device="cuda", generator=g) + 0.5
        args = (x, w, b, gamma, be)
        out = kernel(*args)
        torch.cuda.synchronize()
        ref = plain(*args)
        max_abs = 0.0
        for name, got, want in zip(("y", "h", "mean", "var"), out, ref):
            err = (got - want).abs().max().item()
            max_abs = max(max_abs, err)
            if not torch.allclose(got, want, **TOL):
                fail(f"B1 {name} disagrees with its plain version at {label} B={B} "
                     f"F={F} H={H}: max abs {err:.3e}, tolerance {TOL}")
        if not all(torch.equal(a, c) for a, c in zip(out, kernel(*args))):
            fail(f"B1 is not deterministic at {label}")
        reps = 10 if B * F * H > 1e9 else 30
        ms = cuda_ms(lambda: kernel(*args), reps)
        dev_ms, dev_ops = device_ms(lambda: kernel(*args), reps)
        issue_ms = host_ms(lambda: kernel(*args))
        plain_ms = cuda_ms(lambda: plain(*args), reps)
        addmm_ms = cuda_ms(lambda: torch.addmm(b, x, w), reps)
        flops, nbytes = work_b1(B, F, H)
        bms, by = bound_ms(f32_ms(flops), nbytes)
        grad_err = None
        if (B, F, H) in grad_shapes:
            gy = torch.randn(B, H, device="cuda", generator=g)
            grads = []
            for fn in (lambda *a: fused_linear_bn_relu(*a)[0], lambda *a: plain(*a)[0]):
                leaves = [t.clone().requires_grad_() for t in args]
                (fn(*leaves) * gy).sum().backward()
                grads.append([t.grad for t in leaves])
            grad_err = 0.0
            for name, got, want in zip(("dx", "dw", "db", "dgamma", "dbeta"), *grads):
                err = (got - want).abs().max().item()
                grad_err = max(grad_err, err)
                if not torch.allclose(got, want, **TOL):
                    fail(f"B1 gradient {name} disagrees with autograd through the plain "
                         f"version at {label}: max abs {err:.3e}, tolerance {TOL}")
        rows.append(dict(label=label, B=B, F=F, H=H, split=plan.split, ctas=plan.ctas,
                         max_abs_err=max_abs, grad_max_abs_err=grad_err, ms=ms,
                         device_ms=dev_ms, host_ms=issue_ms, plain_ms=plain_ms,
                         addmm_ms=addmm_ms, flops=flops, bytes=nbytes, ops_ms=f32_ms(flops),
                         bound_ms=bms, bound_by=by))
        print(f"B1 {label:>16} B={B:5d} F={F:6d} H={H:5d} (cluster {plan.split}, slice "
              f"{plan.slice}, {plan.ctas} CTAs)  max_abs_err={max_abs:.3e} "
              f"grad_max_abs_err={'n/a' if grad_err is None else f'{grad_err:.3e}'} "
              f"(tol {TOL})  kernel {ms:.4f} ms (device {fmt_ms(dev_ms)}, "
              f"{dev_ops:g} device ops; host issue {issue_ms:.4f} ms)  plain {plain_ms:.4f} ms  "
              f"addmm(GEMM only) {addmm_ms:.4f} ms  bound {bms:.4f} ms ({by})  "
              f"{flops / ms / 1e9:.2f} TFLOP/s", flush=True)
    return rows


def _trial_inputs(K, B, F, H, per_trial, seed, eval_mode):
    """Seeded operands of one trial-axis call: x (K, B, F) or one (B, F), w
    (K, F, H) and the vectors (K, H) (five for B2, three for B1)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(*((K,) if per_trial else ()), B, F, device="cuda", generator=g)
    w = (torch.rand(K, F, H, device="cuda", generator=g) * 2 - 1) / math.sqrt(max(F, 1))
    b, be = (torch.randn(K, H, device="cuda", generator=g) * 0.1 for _ in range(2))
    gamma = torch.rand(K, H, device="cuda", generator=g) + 0.5
    if not eval_mode:
        return (x, w, b, gamma, be)
    rm = torch.randn(K, H, device="cuda", generator=g) * 0.1
    rv = torch.rand(K, H, device="cuda", generator=g) + 0.5
    return (x, w, b, gamma, be, rm, rv)


def check_trial_kernels():
    """B1 and B2 with a trial axis against their plain versions: B1 at the
    three blocks of a 16-trial DirectPred training step (x shared and x per
    trial), B2 at the three blocks of a 16-trial validation of 400 rows (x
    shared), K = 1 (the same bits as the call without the axis) and a ragged
    K = 3; within TOL, two calls bit for bit, one launch per stacked call (two
    above 64 rows for B1), B1's gradients against autograd through the plain
    version. Prints CUDA-event, device and host-issue times per stacked call
    and the bound; returns per-shape rows."""
    import torch
    from flexynesis_torch.kernels.fused_linear import (
        ROW_TILE,
        fused_linear_bn_relu,
        fused_linear_bn_relu_eval,
        fused_linear_bn_relu_eval_ref,
        fused_linear_bn_relu_forward,
        fused_linear_bn_relu_ref,
        plan_b1,
        plan_b2,
    )

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    h_gex, h_cnv = int(GEX * HIDDEN_FACTOR), int(CNV * HIDDEN_FACTOR)
    blocks = [("encoder_gex", GEX, h_gex), ("encoder_cnv", CNV, h_cnv),
              ("head_subtype", LATENT, SUP_HIDDEN)]
    val_rows = int(math.ceil(FIT_TRAIN * VAL_SIZE))
    cases = []  # (kernel, label, K, B, F, H, x per trial)
    for name, F, H in blocks:
        cases += [("B1", f"{name}_shared_x", TRIALS, BATCH, F, H, False),
                  ("B1", f"{name}_x_per_trial", TRIALS, BATCH, F, H, True)]
    cases += [("B1", "k1_encoder_gex", 1, BATCH, GEX, h_gex, False),
              ("B1", "k3_ragged", 3, 37, 129, 67, True),
              ("B1", "k3_ragged_b130", 3, 130, 129, 67, False)]
    cases += [("B2", f"{name}_val{val_rows}", TRIALS, val_rows, F, H, False)
              for name, F, H in blocks]
    cases += [("B2", "k1_encoder_gex", 1, val_rows, GEX, h_gex, False),
              ("B2", "k3_ragged", 3, 37, 129, 67, True)]
    rows = []
    for kind, label, K, B, F, H, per_trial in cases:
        args = _trial_inputs(K, B, F, H, per_trial, K * 7 + B * 5 + F * 3 + H, kind == "B2")
        if kind == "B2":
            kernel, plain, counter = (fused_linear_bn_relu_eval, fused_linear_bn_relu_eval_ref,
                                      fused_linear_bn_relu_eval)
            per_call, plan = 1, plan_b2(B, F, H, sms, K)
            ops_ms = K * work_b2(B, F, H)[0]  # 3xTF32, as work_b2 counts it
            nbytes = 4 * ((K if per_trial else 1) * B * F + K * (F * H + 5 * H + B * H))
            flops = K * (2 * B * F * H + 6 * B * H)
        else:
            kernel, plain, counter = (fused_linear_bn_relu_forward, fused_linear_bn_relu_ref,
                                      fused_linear_bn_relu)
            per_call, plan = (1 if B <= ROW_TILE else 2), plan_b1(B, F, H, sms, K)
            flops = K * work_b1(B, F, H)[0]
            nbytes = 4 * ((K if per_trial else 1) * B * F + K * (F * H + 2 * B * H + 5 * H))
            ops_ms = f32_ms(flops)
        before = counter.launches
        out = kernel(*args)
        torch.cuda.synchronize()
        if counter.launches != before + per_call:
            fail(f"{kind} with a trial axis made {counter.launches - before} launches at {label}, "
                 f"expected {per_call}")
        ref = plain(*args)
        outs, refs = ((out,), (ref,)) if kind == "B2" else (out, ref)
        max_abs = 0.0
        for got, want in zip(outs, refs):
            max_abs = max(max_abs, float((got - want).abs().max()))
            if not torch.allclose(got, want, **TOL):
                fail(f"{kind} with a trial axis disagrees with its plain version at {label} "
                     f"K={K} B={B} F={F} H={H}: max abs {max_abs:.3e}, tolerance {TOL}")
        again = kernel(*args)
        if not all(torch.equal(a, c) for a, c in zip(outs, (again,) if kind == "B2" else again)):
            fail(f"{kind} with a trial axis is not deterministic at {label}")
        if K == 1:  # the stacked call of one trial is the call without the axis
            flat = [a[0] if a.dim() == 3 or (a.dim() == 2 and i > 0) else a
                    for i, a in enumerate(args)]
            single = kernel(*flat)
            singles = (single,) if kind == "B2" else single
            if not all(torch.equal(a[0], c) for a, c in zip(outs, singles)):
                fail(f"{kind}: K = 1 differs from the call without a trial axis at {label}")
        grad_err = None
        if kind == "B1" and B == BATCH and K == TRIALS:
            gy = torch.randn(K, B, H, device="cuda", generator=torch.Generator(
                device="cuda").manual_seed(B + F))
            grads = []
            for fn in (lambda *a: fused_linear_bn_relu(*a)[0], lambda *a: plain(*a)[0]):
                leaves = [t.clone().requires_grad_() for t in args]
                (fn(*leaves) * gy).sum().backward()
                grads.append([t.grad for t in leaves])
            grad_err = 0.0
            for name, got, want in zip(("dx", "dw", "db", "dgamma", "dbeta"), *grads):
                err = float((got - want).abs().max())
                grad_err = max(grad_err, err)
                if not torch.allclose(got, want, **TOL):
                    fail(f"B1 trial-axis gradient {name} disagrees with autograd through the "
                         f"plain version at {label}: max abs {err:.3e}, tolerance {TOL}")
        reps = 30
        ms = cuda_ms(lambda: kernel(*args), reps)
        dev_ms, dev_ops = device_ms(lambda: kernel(*args), reps)
        issue_ms = host_ms(lambda: kernel(*args))
        plain_ms = cuda_ms(lambda: plain(*args), reps)
        bms, by = bound_ms(ops_ms, nbytes)
        rows.append(dict(kernel=kind, label=label, K=K, B=B, F=F, H=H, per_trial=per_trial,
                         launches=per_call, split=plan.split, ctas=plan.ctas,
                         max_abs_err=max_abs,
                         grad_max_abs_err=grad_err, ms=ms, device_ms=dev_ms, host_ms=issue_ms,
                         plain_ms=plain_ms, flops=flops, bytes=nbytes, ops_ms=ops_ms,
                         bound_ms=bms, bound_by=by))
        print(f"{kind} trials {label:>22} K={K:3d} B={B:4d} F={F:5d} H={H:4d} x "
              f"{'per trial' if per_trial else 'shared'} (cluster {plan.split}, {plan.ctas} CTAs) "
              f"max_abs_err={max_abs:.3e} grad_max_abs_err="
              f"{'n/a' if grad_err is None else f'{grad_err:.3e}'} (tol {TOL}) deterministic, "
              f"{per_call} launch(es) per call  kernel {ms:.4f} ms (device {fmt_ms(dev_ms)}, "
              f"{dev_ops:g} device ops; host issue {issue_ms:.4f} ms)  plain {plain_ms:.4f} ms  "
              f"bound {bms:.5f} ms ({by}{', 3xTF32' if kind == 'B2' else ', f32'})", flush=True)
    return rows


B3_TOL = dict(rtol=1e-5, atol=1e-6)  # one f32 mean; only the order of summation differs


def work_b3(N: int, M: int, d: int):
    """(FLOPs, bytes) of one B3 call: the dot products, the two norms and about
    six operations per pair (expansion, clamp, division, exp, sum); x and y
    read once and one float written, in f32."""
    return 2 * N * M * d + 2 * (N + M) * d + 6 * N * M, 4 * ((N + M) * d + 1)


def b3_grad_err(fused_fn, plain_fn, inputs, what):
    """Max abs difference of B3's gradients from autograd through the plain
    version; tolerance rtol 1e-4 and atol 1e-4 of the largest plain gradient
    (the gradients scale as 1 / (N M d^2), so an absolute atol would say
    nothing)."""
    import torch

    grads = []
    for fn in (fused_fn, plain_fn):
        leaves = [t.clone().requires_grad_() for t in inputs]
        fn(*leaves).backward()
        grads.append([t.grad for t in leaves])
    err = 0.0
    for got, want in zip(*grads):
        atol = 1e-4 * float(want.abs().max())
        err = max(err, float((got - want).abs().max()))
        if not torch.allclose(got, want, rtol=1e-4, atol=atol):
            fail(f"B3 gradient of {what} disagrees with autograd through the plain "
                 f"version: max abs {err:.3e}, rtol 1e-4, atol {atol:.3e}")
    return err


def check_b3(shapes, grad_shapes):
    """Hold B3 against its plain version at each (label, (N, M, d)): the mean
    within B3_TOL, two calls bit for bit, and at ``grad_shapes`` the
    gradients of the kernel mean (x against y and x against itself) and of
    the MMD term (a 200-draw prior against the batch) against autograd
    through the plain version. Returns per-shape rows."""
    import torch
    from flexynesis_torch.kernels.mmd import (
        GaussianKernelMean,
        compute_mmd_fused,
        gaussian_kernel_mean as kernel,
        gaussian_kernel_mean_ref as plain,
    )
    from flexynesis_torch.ops.losses import compute_mmd

    rows = []
    for label, (N, M, d) in shapes:
        g = torch.Generator(device="cuda").manual_seed(N * 7 + M * 3 + d)
        x = torch.randn(N, d, device="cuda", generator=g)
        y = torch.randn(M, d, device="cuda", generator=g) * 0.5 + 0.1
        out = kernel(x, y)
        torch.cuda.synchronize()
        ref = plain(x, y)
        err = float((out - ref).abs())
        if not torch.allclose(out, ref, **B3_TOL):
            fail(f"B3 disagrees with its plain version at {label} N={N} M={M} d={d}: "
                 f"{float(out)!r} vs {float(ref)!r}, tolerance {B3_TOL}")
        if not torch.equal(out, kernel(x, y)):
            fail(f"B3 is not deterministic at {label}")
        reps = 10 if N * M * d > 1e8 else 50
        ms = cuda_ms(lambda: kernel(x, y), reps)
        dev_ms, dev_ops = device_ms(lambda: kernel(x, y), reps)
        plain_ms = cuda_ms(lambda: plain(x, y), reps)
        flops, nbytes = work_b3(N, M, d)
        bms, by = bound_ms(f32_ms(flops), nbytes)
        g_err = None
        if (N, M, d) in grad_shapes:
            g_err = max(
                b3_grad_err(GaussianKernelMean.apply, plain, (x, y), "the kernel mean"),
                b3_grad_err(lambda a: GaussianKernelMean.apply(a, a), lambda a: plain(a, a),
                            (y,), "the kernel mean of y against itself"),
                b3_grad_err(compute_mmd_fused, compute_mmd,
                            (torch.randn(200, d, device="cuda", generator=g), y), "the MMD"),
            )
        rows.append(dict(label=label, shape=[N, M, d], max_abs_err=err,
                         grad_max_abs_err=g_err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                         flops=flops, bytes=nbytes, ops_ms=f32_ms(flops), bound_ms=bms,
                         bound_by=by))
        print(f"B3 {label:>16} N={N:5d} M={M:5d} d={d:4d}  mean={float(out):.7f} "
              f"abs_err={err:.3e} (tol {B3_TOL}) deterministic "
              f"grad_max_abs_err={'n/a' if g_err is None else f'{g_err:.3e}'}  "
              f"kernel {ms:.4f} ms (device {fmt_ms(dev_ms)}, {dev_ops:g} device ops)  "
              f"plain {plain_ms:.4f} ms  bound {bms:.6f} ms ({by})  "
              f"{flops / ms / 1e9:.3f} TFLOP/s", flush=True)
    return rows


MMD_TOL = dict(rtol=1e-4, atol=2e-6)  # a difference of three means near 1


def work_term(N: int, M: int, d: int, K: int = 1, per_trial: bool = True):
    """(FLOPs, bytes) of the MMD terms of K trials: the three kernel means, a
    self set over its distinct pairs (N (N + 1) / 2), as in ``work_b3``; x and
    y read once and four floats written per trial, in f32. A prior shared by
    the trials (``per_trial`` False) is read, and its self-mean needed, once."""
    n_x = K if per_trial else 1
    pairs = n_x * N * (N + 1) // 2 + K * (M * (M + 1) // 2 + N * M)
    rows = n_x * N + K * M
    return 2 * pairs * d + 2 * rows * d + 6 * pairs, 4 * (rows * d + 4 * K)


def check_mmd_term(shapes, grad_shapes):
    """Hold B3's one-launch MMD term against its plain version at each
    (label, (N prior draws, M batch rows, d)): the three means within B3_TOL
    and the MMD within MMD_TOL of ``mmd_term_ref``, two calls bit for bit, one
    launch per call; at ``grad_shapes`` the gradients of the term (of both
    inputs, and of the batch alone as the VAE takes them) against autograd
    through ``ops.losses.compute_mmd``. Times ``compute_mmd_fused``, the
    call of the VAE's loss. Returns per-shape rows."""
    import torch
    from flexynesis_torch.kernels.mmd import (
        compute_mmd_fused,
        gaussian_kernel_mean,
        mmd_term_forward as kernel,
        mmd_term_ref,
    )
    from flexynesis_torch.ops.losses import compute_mmd as plain

    rows = []
    for label, (N, M, d) in shapes:
        g = torch.Generator(device="cuda").manual_seed(N * 11 + M * 5 + d)
        x = torch.randn(N, d, device="cuda", generator=g)
        y = torch.randn(M, d, device="cuda", generator=g) * 0.5 + 0.1
        before = gaussian_kernel_mean.launches
        out = kernel(x, y)
        torch.cuda.synchronize()
        if gaussian_kernel_mean.launches != before + 1:
            fail(f"the MMD term made {gaussian_kernel_mean.launches - before} launches at {label}")
        ref = mmd_term_ref(x, y)
        mean_err = float((out[:3] - ref[:3]).abs().max())
        mmd_err = float((out[3] - ref[3]).abs())
        if not (torch.allclose(out[:3], ref[:3], **B3_TOL)
                and torch.allclose(out[3], ref[3], **MMD_TOL)):
            fail(f"the B3 MMD term disagrees with its plain version at {label} N={N} M={M} "
                 f"d={d}: {out.tolist()} vs {ref.tolist()}, tolerances {B3_TOL} (means), "
                 f"{MMD_TOL} (MMD)")
        if not torch.equal(out, kernel(x, y)):
            fail(f"the B3 MMD term is not deterministic at {label}")
        reps = 50
        ms = cuda_ms(lambda: compute_mmd_fused(x, y), reps)
        dev_ms, dev_ops = device_ms(lambda: compute_mmd_fused(x, y), reps)
        issue_ms = host_ms(lambda: compute_mmd_fused(x, y))
        plain_ms = cuda_ms(lambda: plain(x, y), reps)
        flops, nbytes = work_term(N, M, d)
        bms, by = bound_ms(f32_ms(flops), nbytes)
        g_err = None
        if (N, M, d) in grad_shapes:
            g_err = max(b3_grad_err(compute_mmd_fused, plain, (x, y), "the MMD term"),
                        b3_grad_err(lambda a: compute_mmd_fused(x, a), lambda a: plain(x, a),
                                    (y,), "the MMD term in the batch"))
        rows.append(dict(label=label, shape=[N, M, d], max_abs_err=max(mean_err, mmd_err),
                         grad_max_abs_err=g_err, ms=ms, device_ms=dev_ms, host_ms=issue_ms,
                         plain_ms=plain_ms, flops=flops, bytes=nbytes, ops_ms=f32_ms(flops),
                         bound_ms=bms, bound_by=by))
        print(f"B3 term {label:>12} N={N:5d} M={M:5d} d={d:4d}  mmd={float(out[3]):.7e} "
              f"means_abs_err={mean_err:.3e} (tol {B3_TOL}) mmd_abs_err={mmd_err:.3e} "
              f"(tol {MMD_TOL}) deterministic, 1 launch  "
              f"grad_max_abs_err={'n/a' if g_err is None else f'{g_err:.3e}'}  "
              f"compute_mmd_fused {ms:.4f} ms (device {fmt_ms(dev_ms)}, {dev_ops:g} device "
              f"ops; host issue {issue_ms:.4f} ms)  plain compute_mmd {plain_ms:.4f} ms  bound {bms:.6f} ms ({by})",
              flush=True)
    return rows


def check_b3_trials():
    """B3's MMD term with a trial axis against its plain version: the
    16-trial training term (the 200-draw prior against each trial's 64-row
    batch) and validation term (against the 400-row split), the prior shared
    by the trials (read at a trial stride of 0) and per trial, K = 1 and a
    ragged K = 3: the means within B3_TOL and the MMD within MMD_TOL of
    ``mmd_term_ref``, one launch per call, two calls bit for bit, and every
    trial bit for bit equal to a one-trial call on its slice; at the
    training shapes the gradients of the stacked term against autograd
    through ``ops.losses.compute_mmd``. Prints CUDA-event, device and
    host-issue times per call, the plain version's and the bound; returns
    per-shape rows."""
    import torch
    from flexynesis_torch.kernels.mmd import (
        compute_mmd_fused,
        gaussian_kernel_mean,
        mmd_term_forward as kernel,
        mmd_term_ref,
    )
    from flexynesis_torch.ops.losses import N_PRIOR_SAMPLES, compute_mmd as plain

    val_rows = int(math.ceil(FIT_TRAIN * VAL_SIZE))
    P = N_PRIOR_SAMPLES
    cases = []  # (label, K, N, M, d, prior per trial)
    for part, M in (("train", BATCH), (f"val{val_rows}", val_rows)):
        cases += [(f"{part}_shared", TRIALS, P, M, LATENT, False),
                  (f"{part}_per_trial", TRIALS, P, M, LATENT, True)]
    cases += [("k1_train", 1, P, BATCH, LATENT, True), ("k3_ragged", 3, 37, 129, 17, True)]
    rows = []
    for label, K, N, M, d, per_trial in cases:
        g = torch.Generator(device="cuda").manual_seed(K * 13 + N * 7 + M * 3 + d)
        x = torch.randn(*((K,) if per_trial else ()), N, d, device="cuda", generator=g)
        y = torch.randn(K, M, d, device="cuda", generator=g) * 0.5 + 0.1
        before = gaussian_kernel_mean.launches
        out = kernel(x, y)
        torch.cuda.synchronize()
        if gaussian_kernel_mean.launches != before + 1:
            fail(f"B3 with a trial axis made {gaussian_kernel_mean.launches - before} launches "
                 f"at {label}, expected 1")
        ref = mmd_term_ref(x, y)
        mean_err = float((out[:, :3] - ref[:, :3]).abs().max())
        mmd_err = float((out[:, 3] - ref[:, 3]).abs().max())
        if not (torch.allclose(out[:, :3], ref[:, :3], **B3_TOL)
                and torch.allclose(out[:, 3], ref[:, 3], **MMD_TOL)):
            fail(f"B3 with a trial axis disagrees with its plain version at {label} K={K} N={N} "
                 f"M={M} d={d}: means max abs {mean_err:.3e} (tol {B3_TOL}), MMD max abs "
                 f"{mmd_err:.3e} (tol {MMD_TOL})")
        if not torch.equal(out, kernel(x, y)):
            fail(f"B3 with a trial axis is not deterministic at {label}")
        for k in range(K):  # each trial's bits are a one-trial call's
            single = kernel(x[k] if per_trial else x, y[k])
            if not torch.equal(out[k], single):
                fail(f"B3 trial {k} of K={K} differs from the one-trial call on its slice at "
                     f"{label}: {out[k].tolist()} vs {single.tolist()}")
        g_err = None
        if label.startswith("train") and K == TRIALS:
            g_err = b3_grad_err(lambda a, b: compute_mmd_fused(a, b).sum(),
                                lambda a, b: plain(a, b).sum(), (x, y),
                                f"the stacked MMD term ({label})")
        reps = 30
        ms = cuda_ms(lambda: compute_mmd_fused(x, y), reps)
        dev_ms, dev_ops = device_ms(lambda: compute_mmd_fused(x, y), reps)
        issue_ms = host_ms(lambda: compute_mmd_fused(x, y))
        plain_ms = cuda_ms(lambda: plain(x, y), reps)
        flops, nbytes = work_term(N, M, d, K, per_trial)
        bms, by = bound_ms(f32_ms(flops), nbytes)
        rows.append(dict(label=label, K=K, shape=[K, N, M, d], per_trial=per_trial,
                         max_abs_err=max(mean_err, mmd_err), grad_max_abs_err=g_err, ms=ms,
                         device_ms=dev_ms, host_ms=issue_ms, plain_ms=plain_ms, flops=flops,
                         bytes=nbytes, ops_ms=f32_ms(flops), bound_ms=bms, bound_by=by))
        print(f"B3 trials {label:>18} K={K:3d} N={N:4d} M={M:4d} d={d:3d} prior "
              f"{'per trial' if per_trial else 'shared'}  means_abs_err={mean_err:.3e} "
              f"(tol {B3_TOL}) mmd_abs_err={mmd_err:.3e} (tol {MMD_TOL}) deterministic, "
              f"each trial = its one-trial call bit for bit, 1 launch  grad_max_abs_err="
              f"{'n/a' if g_err is None else f'{g_err:.3e}'}  compute_mmd_fused {ms:.4f} ms "
              f"(device {fmt_ms(dev_ms)}, {dev_ops:g} device ops; host issue {issue_ms:.4f} ms)"
              f"  plain compute_mmd {plain_ms:.4f} ms  bound {bms:.6f} ms ({by})", flush=True)
    return rows


def write_model(workdir: Path):
    """Test folder, a seeded fused DirectPred and its artifacts, saved as the
    CLI reads them. Returns (test folder, weights, config, artifacts)."""
    import torch
    from flexynesis_torch.data.preprocessing import fit_standard_scaler, ordinal_encoder_state
    from flexynesis_torch.inference import (
        build_dataset_namespace, save_model, save_model_config, write_artifacts,
    )
    from flexynesis_torch.models.direct_pred import DirectPred
    from flexynesis_torch.ops.fused_mlp import FusedMLP
    from flexynesis_torch.utils.csvio import read_matrix
    from flexynesis_torch.utils.synthetic import write_synthetic_folder

    data = workdir / "data"
    layers = write_synthetic_folder(
        str(data), n_train=N_TRAIN, n_test=N_TEST,
        n_features={"gex": GEX, "cnv": CNV}, n_classes=N_CLASSES, seed=0,
    )
    transforms, feature_lists = {}, {}
    for layer in layers:
        names, _, mat = read_matrix(str(data / "train" / f"{layer}.csv"))
        transforms[layer] = fit_standard_scaler(mat.T, names)
        feature_lists[layer] = names
    artifacts = {
        "schema_version": 1, "data_types": layers, "original_modalities": layers,
        "target_variables": ["subtype"], "covariate_vars": [], "join_key": "JoinKey",
        "string_organism": 9606, "string_node_name": "gene_name",
        "feature_lists": feature_lists, "transforms": transforms,
        "label_encoders": {
            "subtype": ordinal_encoder_state([f"grp{i}" for i in range(N_CLASSES)])
        },
    }
    config = {"output_dims": {"subtype": N_CLASSES},
              "variable_types": {"subtype": "categorical"}}
    hyper = {"latent_dim": LATENT, "hidden_dim_factor": HIDDEN_FACTOR,
             "supervisor_hidden_dim": SUP_HIDDEN, "lr": 1e-3, "epochs": 10,
             "batch_size": BATCH, "fused_kernels": True}
    model = DirectPred(hyper, build_dataset_namespace(config, artifacts),
                       target_variables=["subtype"], device="cuda")
    model.init_params(seed=0)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():  # running statistics as after training
        for block in model.module.modules():
            if isinstance(block, FusedMLP):
                n = block.running_mean.numel()
                block.running_mean.copy_(torch.randn(n, generator=g) * 0.1)
                block.running_var.copy_(torch.rand(n, generator=g) * 0.5 + 0.1)
    hidden = [model.module.encoder_gex.layer_1_kernel.shape[1],
              model.module.encoder_cnv.layer_1_kernel.shape[1]]
    if hidden != [int(GEX * HIDDEN_FACTOR), int(CNV * HIDDEN_FACTOR)]:
        fail(f"unexpected hidden widths {hidden}")
    weights = workdir / "smoke.final_model.safetensors"
    save_model(model, str(weights))
    config_path = workdir / "smoke.final_model_config.json"
    save_model_config(model, str(config_path))
    art = workdir / "smoke.artifacts.json"
    write_artifacts(artifacts, str(art))
    return data / "test", weights, config_path, art


def run_cli(test, weights, art, outdir: Path, device: str) -> float:
    from flexynesis_torch.__main__ import main

    t0 = time.perf_counter()
    rc = main(["--pretrained_model", str(weights), "--artifacts", str(art),
               "--data_path_test", str(test), "--outdir", str(outdir),
               "--prefix", "smoke", "--disable_marker_finding", "--device", device])
    if rc != 0:
        fail(f"CLI on {device} returned {rc}")
    return time.perf_counter() - t0


def read_outputs(outdir: Path, n: int = N_TEST, classes: int = N_CLASSES):
    """(samples, embeddings, probabilities, stats rows) of an inference run
    over ``n`` samples and ``classes`` classes, checked for shape and finiteness."""
    import numpy as np
    from flexynesis_torch.utils.csvio import read_matrix, read_table

    samples, _, emb = read_matrix(str(outdir / "smoke.embeddings_test.csv"))
    if emb.shape != (n, LATENT) or not np.isfinite(emb).all():
        fail(f"embeddings: shape {emb.shape}, finite {np.isfinite(emb).all()}")
    _, columns, rows = read_table(str(outdir / "smoke.predicted_labels.csv"))
    prob = np.array([float(r[columns.index("probability")]) for r in rows])
    if prob.size != n * classes or not np.isfinite(prob).all():
        fail(f"predicted_labels: {prob.size} probabilities, expected {n} x {classes}")
    sums = prob.reshape(n, classes).sum(axis=1)
    if not np.allclose(sums, 1.0, atol=1e-5):
        fail("predicted probabilities do not sum to one")
    _, stat_cols, stat_rows = read_table(str(outdir / "smoke.stats.csv"))
    values = [float(r[stat_cols.index("value")]) for r in stat_rows
              if r[stat_cols.index("value")] != ""]
    if not values or not np.isfinite(values).all():
        fail(f"stats.csv holds no finite metric: {stat_rows}")
    return samples, emb, prob, stat_rows


def compare_outputs(out_card: Path, out_cpu: Path, n: int, classes: int, phase: str):
    """Hold the card's inference outputs against the CPU run's; returns the
    card run's stats rows."""
    import numpy as np

    s_gpu, emb_gpu, p_gpu, stats = read_outputs(out_card, n, classes)
    s_cpu, emb_cpu, p_cpu, _ = read_outputs(out_cpu, n, classes)
    if s_gpu != s_cpu:
        fail(f"{phase}: the cuda and cpu runs scored different samples")
    emb_err = float(np.abs(emb_gpu - emb_cpu).max())
    p_err = float(np.abs(p_gpu - p_cpu).max())
    if not (np.allclose(emb_gpu, emb_cpu, **TOL) and np.allclose(p_gpu, p_cpu, **TOL)):
        fail(f"{phase}: cuda and cpu outputs differ: embeddings {emb_err:.3e}, "
             f"probabilities {p_err:.3e}")
    print(f"{phase}: cuda vs cpu max abs diff: embeddings {emb_err:.3e}, "
          f"probabilities {p_err:.3e} (tol {TOL})", flush=True)
    return stats


def serve(workdir: Path):
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from flexynesis_torch.data.inference_importer import DataImporterInference
    from flexynesis_torch.inference import reconstruct_model
    from flexynesis_torch.kernels.fused_linear import fused_linear_bn_relu_eval as kernel
    from flexynesis_torch.utils.csvio import write_rows
    from flexynesis_torch.utils.metrics import evaluate_wrapper, get_predicted_labels

    t0 = time.perf_counter()
    test, weights, config_path, art = write_model(workdir)
    print(f"serving: wrote the test folder and the model in {time.perf_counter() - t0:.2f} s",
          flush=True)

    kernel.launches = 0
    cli_s = run_cli(test, weights, art, workdir / "out_cuda", "cuda")
    launches = kernel.launches
    expected = B2_PER_FORWARD * CLI_FORWARDS
    if launches != expected:
        fail(f"B2 launched {launches} times in the CLI run, expected {expected}")
    print(f"serving: CLI on cuda {cli_s:.3f} s, B2 launches {launches} "
          f"({B2_PER_FORWARD} per eval forward x {CLI_FORWARDS} forwards)", flush=True)

    cpu_s = run_cli(test, weights, art, workdir / "out_cpu", "cpu")
    print(f"serving: CLI on cpu (reference) {cpu_s:.3f} s", flush=True)
    stats = compare_outputs(workdir / "out_cuda", workdir / "out_cpu", N_TEST, N_CLASSES,
                            "serving")
    for r in stats:
        print("serving: stats", ",".join(r), flush=True)

    # the CLI's steps one by one, on the host clock, in seconds
    phases = {}
    t = time.perf_counter()
    model = reconstruct_model(str(weights), str(config_path), str(art), device="cuda")
    phases["reconstruct_model"] = time.perf_counter() - t
    t = time.perf_counter()
    cohort = DataImporterInference(str(test), str(art), verbose=False).import_data()
    phases["import_data"] = time.perf_counter() - t
    t = time.perf_counter()
    model.transform(cohort)
    phases["transform"] = time.perf_counter() - t
    t = time.perf_counter()
    preds = model.predict(cohort)
    phases["predict"] = time.perf_counter() - t
    t = time.perf_counter()
    write_rows(str(workdir / "phases.predicted_labels.csv"),
               get_predicted_labels(preds, cohort, "test", model.model_name))
    phases["predicted_labels_csv"] = time.perf_counter() - t
    t = time.perf_counter()
    evaluate_wrapper(model.model_name, preds, cohort)
    phases["metrics"] = time.perf_counter() - t
    print("serving: phases of one inference run (host clock, s): "
          + json.dumps({k: round(v, 4) for k, v in phases.items()}), flush=True)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        model.predict(cohort)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in device)
    if busy_us > 0:
        top = sorted(device, key=lambda e: -e.self_device_time_total)[:6]
        print(f"serving: profiled predict of the cohort: wall {wall_us:.0f} us, device busy "
              f"{busy_us:.0f} us ({100 * busy_us / wall_us:.1f}%); top: "
              + "; ".join(f"{e.key[:48]} {e.self_device_time_total:.0f} us" for e in top),
              flush=True)
        print("serving: the port's kernels in the profiled predict: " + port_kernels(device, 1),
              flush=True)
    else:
        print("serving: profiled predict: the profiler saw no device time (not measured)")

    batch = cohort.subset(np.arange(BATCH))
    for name, ds in (("cohort", cohort), ("batch64", batch)):
        model.predict(ds)  # warm-up
        times = []
        for _ in range(5):
            t = time.perf_counter()
            model.predict(ds)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        med = statistics.median(times)
        print(f"serving: predict {name} ({len(ds)} samples) x5: median {med * 1e3:.3f} ms, "
              f"{len(ds) / med:.0f} samples/s", flush=True)
    return launches


HPO_CONFIG = """%s:
  - {type: Categorical, categories: [%d], name: latent_dim}
  - {type: Categorical, categories: [%s], name: hidden_dim_factor}
  - {type: Categorical, categories: [0.001], name: lr}
  - {type: Categorical, categories: [%d], name: supervisor_hidden_dim}
  - {type: Categorical, categories: [%d], name: epochs}
  - {type: Categorical, categories: [%d], name: batch_size}
  - {type: Categorical, categories: [true], name: fused_kernels}
"""


def marker_args(markers: bool):
    """The CLI's marker-finding flags: both methods, or none."""
    if markers:
        return ["--feature_importance_method", "Both"]
    return ["--disable_marker_finding"]


def train_args(data: Path, config: Path, outdir: Path, device: str,
               model_class: str = "DirectPred", extra=(), markers: bool = False):
    return ["--data_path", str(data), "--model_class", model_class, *extra,
            "--data_types", "gex,cnv", "--target_variables", "subtype",
            "--config_path", str(config), "--hpo_iter", "1",
            "--features_top_percentile", str(TOP_PERCENTILE), "--variance_threshold", "0",
            "--features_min", str(FEATURES_MIN),
            "--safetensors", *marker_args(markers), "--device", device,
            "--outdir", str(outdir), "--prefix", "fit"]


def model_kwargs(model) -> dict:
    """The constructor arguments beside the config that rebuild ``model``'s
    architecture: CrossModalPred's layers, the GNN's conv type."""
    if model.model_name == "CrossModalPred":
        return {"input_layers": model.input_layers, "output_layers": model.output_layers}
    if model.model_name == "GNN":
        return {"gnn_conv_type": model.gnn_conv_type}
    return {}


class ReductionScale:
    """Records, inside the context, the operands and output gradients of
    every graph conv's ``node_linear`` and ``batch_norm_train``: the
    parameters whose gradients sum over the B x N node rows. ``scales()``
    gives each such parameter's (rows n, S) in float64, S the sum of the
    absolute terms of each gradient entry (|dY|^T |X| for a weight)."""

    def __enter__(self):
        from flexynesis_torch.ops import graph_conv

        self.module, self.calls = graph_conv, []
        self.saved = (graph_conv.node_linear, graph_conv.batch_norm_train)

        def node_linear(x, weight, bias=None):
            y = self.saved[0](x, weight, bias)
            return self._watch("linear", y, x, weight, bias)

        def batch_norm_train(h, scale, shift, running_mean, running_var):
            y = self.saved[1](h, scale, shift, running_mean, running_var)
            return self._watch("bn", y, h, scale, shift)

        graph_conv.node_linear, graph_conv.batch_norm_train = node_linear, batch_norm_train
        return self

    def __exit__(self, *exc):
        self.module.node_linear, self.module.batch_norm_train = self.saved

    def _watch(self, kind, y, x, a, b):
        call = {"kind": kind, "x": x.detach().reshape(-1, x.shape[-1]), "params": (a, b)}
        self.calls.append(call)
        y.register_hook(lambda g: call.__setitem__("dy", g.detach().reshape(-1, g.shape[-1])))
        return y

    def scales(self) -> dict:
        """{id(parameter): (n, S)}"""
        import torch
        from flexynesis_torch.ops.mlp import BN_EPS

        out = {}
        for c in self.calls:
            x, dy = c["x"].double(), c["dy"].double()
            a, b = c["params"]
            if c["kind"] == "linear":
                out[id(a)] = (x.shape[0], dy.abs().T @ x.abs())
            else:
                mu = x.mean(0)
                xhat = (x - mu) * torch.rsqrt((x * x).mean(0) - mu * mu + BN_EPS)
                out[id(a)] = (x.shape[0], (dy * xhat).abs().sum(0))
            if b is not None:
                out[id(b)] = (x.shape[0], dy.abs().sum(0))
        return out


# f32's machine epsilon: a reduction of n terms in any order parts from the
# exact sum by about sqrt(n) * EPS_F32 * (sum of |terms|) at most, in practice
EPS_F32 = 2.0 ** -23


def check_card_matches_cpu(model, cohort, label=None, reduction_bound: bool = False):
    """Three training steps from one initialisation with dropout 0 and one
    permutation, on the card and on the CPU: per-step losses and the first
    step's gradients must agree (rtol/atol 1e-4). With ``reduction_bound``
    (a graph of STRING's scale, whose conv and BatchNorm gradients sum over
    B x N rows) each entry of those gradients may part by a further
    sqrt(n) * EPS_F32 * S, S the sum of its terms' absolute values on the
    CPU (``ReductionScale``). One CPU generator seeded alike feeds both runs,
    so a VAE's eps and prior draws and the triplet model's partners are the
    same numbers on both."""
    import contextlib

    import torch
    from flexynesis_torch.train.trainer import Trainer, gather

    label = label or model.model_name
    runs = {}
    for device in (DEVICE, "cpu"):
        m = type(model)(model.config, cohort, target_variables=model.target_variables,
                        device=device, **model_kwargs(model))
        m.init_params(seed=3)
        _no_dropout(m)
        data = m.make_batch(cohort)
        perm = torch.randperm(m.n_train_samples(cohort),
                              generator=torch.Generator().manual_seed(5))
        perm = perm[: 3 * BATCH].reshape(3, BATCH).to(device)
        trainer = Trainer(m.module, m.loss_fn, lr=float(model.config["lr"]))
        gen = torch.Generator().manual_seed(11)
        watch = reduction_bound and device == "cpu"
        with ReductionScale() if watch else contextlib.nullcontext() as scale:
            total, _ = m.loss_fn(gather(data, perm[0]), gen, True)
            grads = torch.autograd.grad(total, trainer.params, allow_unused=True)
        scales = scale.scales() if watch else {}
        trainer.optimizer.step(grads)
        losses = [float(total.detach())] + [float(trainer.train_step(gather(data, p), gen))
                                            for p in perm[1:]]
        runs[device] = (losses, [None if g is None else g.cpu() for g in grads],
                        [scales.get(id(p)) for p in trainer.params])
    (l_gpu, g_gpu, _), (l_cpu, g_cpu, s_cpu) = runs[DEVICE], runs["cpu"]
    if not all(math.isclose(a, b, rel_tol=1e-4) for a, b in zip(l_gpu, l_cpu)):
        fail(f"{label}: training steps disagree between cuda and cpu: "
             f"{l_gpu} vs {l_cpu}")
    grad_err, share = 0.0, 0.0
    for a, b, s in zip(g_gpu, g_cpu, s_cpu):
        if a is None:
            continue
        diff = (a - b).abs().double()
        grad_err = max(grad_err, float(diff.max()))
        tol = 1e-4 + 1e-4 * b.abs().double()
        if s is not None:
            depth = math.sqrt(s[0]) * EPS_F32 * s[1]
            share = max(share, float((diff / depth)[depth > 0].max()))
            tol = tol + depth
        if not bool((diff <= tol).all()):
            fail(f"{label}: first-step gradients disagree between cuda and "
                 f"cpu: {float(diff.max()):.3e}, {float((diff - tol).max()):.3e} over the bound")
    extra = (f" + sqrt(n) eps_f32 sum|terms| for the conv and BatchNorm gradients; their "
             f"largest diff is {share:.3f} of that term") if reduction_bound else ""
    print(f"{label} training: 3 steps cuda vs cpu, losses {l_gpu} vs {l_cpu} (rtol 1e-4); "
          f"first-step gradients max abs diff {grad_err:.3e} (rtol/atol 1e-4{extra})",
          flush=True)


def port_kernels(events, calls: int) -> str:
    """The port's kernels among a profile's device ``events``, by the names
    of their CUDA functions: device time and launches per one of ``calls``."""
    mine = {}
    for e in events:
        for name in KERNEL_FUNCTIONS:
            if name in e.key:
                n, us = mine.get(name, (0, 0.0))
                mine[name] = (n + e.count, us + e.self_device_time_total)
    return ", ".join(f"{k} {us / calls:.2f} us in {n / calls:g} launches"
                     for k, (n, us) in mine.items()) or "none"


def time_steps(model, cohort, label=None):
    """Median host-clock time of one training step (synchronised), and a
    profiled run of PROFILED_STEPS steps with its device-busy share and the
    card's peak allocated memory."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from flexynesis_torch.train.trainer import Trainer, gather

    label = label or model.model_name
    torch.cuda.reset_peak_memory_stats()
    data = model.make_batch(cohort)
    trainer = Trainer(model.module, model.loss_fn, lr=float(model.config["lr"]))
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    n = model.n_train_samples(cohort)
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(9))
    batches = [gather(data, perm[i:i + BATCH].to(DEVICE))
               for i in range(0, n - BATCH + 1, BATCH)]
    for b in batches[:3]:  # warm-up
        trainer.train_step(b, gen)

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t, out

    steps, parts = [], {"forward_and_loss": [], "backward": [], "optimizer": []}
    for i in range(30):
        b = batches[i % len(batches)]
        steps.append(timed(lambda: trainer.train_step(b, gen))[0])
        t_f, (total, _) = timed(lambda: model.loss_fn(b, gen, True))
        t_b, grads = timed(lambda: torch.autograd.grad(total, trainer.params, allow_unused=True))
        t_o, _ = timed(lambda: trainer.optimizer.step(grads))
        for k, v in zip(parts, (t_f, t_b, t_o)):
            parts[k].append(v)
    med = statistics.median(steps)
    print(f"{label} training: train step (batch {BATCH}) x30: median {med * 1e3:.3f} ms "
          f"(min {min(steps) * 1e3:.3f}, max {max(steps) * 1e3:.3f}), {BATCH / med:.0f} "
          "samples/s (host clock, synchronised); medians of its parts: "
          + json.dumps({k: round(statistics.median(v) * 1e3, 3) for k, v in parts.items()})
          + " ms", flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        for b in batches[:PROFILED_STEPS]:
            trainer.train_step(b, gen)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in device)
    if busy_us > 0:
        top = sorted(device, key=lambda e: -e.self_device_time_total)[:8]
        per_step = sum(e.count for e in device) / PROFILED_STEPS
        print(f"{label} training: profiled {PROFILED_STEPS} steps: wall {wall_us:.0f} us, device busy "
              f"{busy_us:.0f} us ({100 * busy_us / wall_us:.1f}%), {per_step:.0f} device "
              "operations per step; top: "
              + "; ".join(f"{e.key[:48]} {e.self_device_time_total:.0f} us" for e in top),
              flush=True)
        print(f"{label} training: the port's kernels per step (device time): "
              + port_kernels(device, PROFILED_STEPS), flush=True)
    else:
        print(f"{label} training: profiled steps: the profiler saw no device "
              "time (not measured)")
    print(f"{label} training: peak allocated on the card while timing "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB", flush=True)
    return med


def train(workdir: Path):
    """The training phase; returns (B1 launches, B2 launches) of the CLI run,
    the batch sizes the run gave B2 (validation, train and test cohorts) and
    the test cohort as the saved model's artifacts import it."""
    import numpy as np
    from flexynesis_torch.__main__ import main as cli, parse_args, run_training
    from flexynesis_torch.data.inference_importer import DataImporterInference
    from flexynesis_torch.kernels.fused_linear import (
        ROW_TILE,
        fused_linear_bn_relu as b1,
        fused_linear_bn_relu_eval as b2,
    )
    from flexynesis_torch.utils.csvio import read_matrix, read_table
    from flexynesis_torch.utils.synthetic import write_synthetic_folder

    t0 = time.perf_counter()
    data = workdir / "fit_data"
    write_synthetic_folder(str(data), n_train=FIT_TRAIN, n_test=FIT_TEST,
                           n_features={"gex": RAW_GEX, "cnv": RAW_CNV},
                           n_classes=N_CLASSES, seed=1)
    config = workdir / "fit_hpo.yaml"
    config.write_text(HPO_CONFIG % ("DirectPred", LATENT, HIDDEN_FACTOR, SUP_HIDDEN,
                                    FIT_EPOCHS, BATCH))
    print(f"training: wrote {FIT_TRAIN}+{FIT_TEST} samples x {RAW_GEX}+{RAW_CNV} raw "
          f"features in {time.perf_counter() - t0:.2f} s", flush=True)

    out = workdir / "fit_out"
    b1.launches = b2.launches = 0
    t = time.perf_counter()
    # main() of the CLI in its two halves, keeping the trained model
    model = run_training(*parse_args(train_args(data, config, out, DEVICE)))
    cli_s = time.perf_counter() - t
    launches = (b1.launches, b2.launches)

    expected_files = [f"fit.feature_logs.{x}.csv" for x in ("gex", "cnv")] + [
        f"fit.{x}.csv" for x in ("embeddings_train", "embeddings_test",
                                 "predicted_labels", "stats")] + [
        "fit.final_model.safetensors", "fit.final_model_config.json", "fit.artifacts.json"]
    missing = [f for f in expected_files if not (out / f).exists()]
    if missing:
        fail(f"training CLI did not write {missing}")
    h_gex, h_cnv = int(GEX * HIDDEN_FACTOR), int(CNV * HIDDEN_FACTOR)
    widths = (model.input_dims,
              [model.module.encoder_gex.layer_1_kernel.shape[1],
               model.module.encoder_cnv.layer_1_kernel.shape[1]],
              model.module.head_subtype.layer_1_kernel.shape[1])
    if widths != ([GEX, CNV], [h_gex, h_cnv], SUP_HIDDEN):
        fail(f"selected/hidden widths {widths}, expected {[GEX, CNV]}, {[h_gex, h_cnv]}, "
             f"{SUP_HIDDEN}")
    res = model.train_result
    n = len(next(iter(model.ann.values())))
    n_fit = n - int(np.ceil(n * VAL_SIZE))
    steps = res.epochs_run * (n_fit // BATCH)
    # a batch beyond one row tile adds the split reduction's merge launch
    b1_per_step = B1_PER_STEP * (1 if BATCH <= ROW_TILE else 2)
    want = (b1_per_step * steps, B2_PER_FORWARD * (res.epochs_run + EVAL_FORWARDS))
    if launches != want:
        fail(f"training launches (B1, B2) = {launches}, expected {want} "
             f"({res.epochs_run} epochs x {n_fit // BATCH} steps)")
    losses = res.history["train_loss"]
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        fail(f"train loss did not fall: {losses}")
    print(f"training: CLI on {DEVICE} {cli_s:.3f} s; selected widths gex {GEX}, cnv {CNV}; "
          f"{res.epochs_run} epochs x {n_fit // BATCH} steps; launches B1 {launches[0]} "
          f"({b1_per_step} per step), B2 {launches[1]} ({B2_PER_FORWARD} per eval forward x "
          f"({res.epochs_run} validations + {EVAL_FORWARDS} evaluation forwards))", flush=True)
    print("training: train loss by epoch " + json.dumps([round(v, 5) for v in losses])
          + "; val loss by epoch " + json.dumps([round(v, 5) for v in res.history["val_loss"]]),
          flush=True)
    print("training: CLI phases (host clock, s): "
          + json.dumps({k: round(v, 4) for k, v in model.cli_phases.items()}), flush=True)
    for r in read_table(str(out / "fit.stats.csv"))[2]:
        print("training: stats", ",".join(r), flush=True)

    # the saved model serves through the port's inference CLI on the card and
    # on the CPU, and the two agree. (Values differ from the training run's
    # test embeddings where the test matrix had missing cells: training
    # imputes the test cohort's medians, inference the training mean.)
    for device in (DEVICE, "cpu"):
        if cli(["--pretrained_model", str(out / "fit.final_model.safetensors"),
                "--artifacts", str(out / "fit.artifacts.json"),
                "--data_path_test", str(data / "test"),
                "--outdir", str(workdir / f"fit_served_{device}"),
                "--prefix", "smoke", "--disable_marker_finding", "--device", device]) != 0:
            fail(f"serving the trained model on {device} returned nonzero")
    # missing training labels give the encoder a missing-value class
    encoder = json.loads((out / "fit.artifacts.json").read_text())["label_encoders"]["subtype"]
    compare_outputs(workdir / f"fit_served_{DEVICE}", workdir / "fit_served_cpu", FIT_TEST,
                    len(encoder["categories"][0]), "training: the saved model served")

    # B2's batch sizes in the CLI run: the validation split each epoch, then
    # the train and test cohorts whole
    n_rows = [len(read_matrix(str(out / f"fit.embeddings_{split}.csv"))[0])
              for split in ("train", "test")]
    b2_rows = sorted({n - n_fit, *n_rows})

    cohort = DataImporterInference(str(data / "test"), str(out / "fit.artifacts.json"),
                                   verbose=False).import_data()
    check_card_matches_cpu(model, cohort)
    time_steps(model, cohort)
    return launches, b2_rows, cohort


class ImportOnce:
    """Memoise the training CLI's import (``__main__._build_importer``) per
    argument set while active: the trial phase's CLI runs reuse the import
    of phase 5's folder (14-17 s of CSV parsing each) instead of repeating
    it; the first import of a set runs as usual."""

    KEYS = ("data_path", "data_types", "covariates", "log_transform", "fusion_type",
            "restrict_to_features", "features_min", "features_top_percentile",
            "correlation_threshold", "variance_threshold", "subsample")

    def __init__(self):
        self.done = {}

    def __enter__(self):
        from flexynesis_torch import __main__ as cli

        self.cli, self.build = cli, cli._build_importer

        def build(args, device):
            key = (*(getattr(args, k) for k in self.KEYS), str(device))
            if key not in self.done:
                importer = self.build(args, device)
                self.done[key] = (importer, importer.import_data())
            importer, datasets = self.done[key]
            return _Imported(importer, datasets)

        cli._build_importer = build
        return self

    def __exit__(self, *exc):
        self.cli._build_importer = self.build


class _Imported:
    """An importer whose ``import_data`` returns the datasets it already made."""

    def __init__(self, importer, datasets):
        self._importer, self._datasets = importer, datasets

    def import_data(self):
        return self._datasets

    def __getattr__(self, name):
        return getattr(self._importer, name)


class Tee:
    """Copy what is printed to standard output while active into ``text``."""

    def __enter__(self):
        self.stdout, self.parts = sys.stdout, []
        sys.stdout = self
        return self

    def write(self, s):
        self.parts.append(s)
        return self.stdout.write(s)

    def flush(self):
        self.stdout.flush()

    def __exit__(self, *exc):
        sys.stdout = self.stdout

    @property
    def text(self) -> str:
        return "".join(self.parts)


class PreActs:
    """While active, records the signs of every watched hidden stack's first
    pre-activations (the Linear before LeakyReLU) in each training-mode
    forward, and with ``mlp`` those of every watched MLP block (its
    BatchNorm's output, before ReLU): ``signs[(tag, block)]`` lists one bool
    tensor (h > 0) per step, (K, B, H) for a stacked forward, (B, H) for one
    model."""

    def __init__(self, mlp: bool = False):
        self.names, self.signs, self.nets = {}, {}, []
        self.mlp = mlp

    def watch(self, model, tag: str):
        """Records ``model``'s hidden stacks (and MLP blocks) under ``tag``;
        returns ``model``."""
        from flexynesis_torch.ops.mlp import MLP, _HiddenStack

        kinds = (_HiddenStack, MLP) if self.mlp else (_HiddenStack,)
        self.nets.append(model)  # alive while watched, so no other module takes its ids
        for name, mod in model.module.named_modules():
            if isinstance(mod, kinds):
                self.names[id(mod)] = (tag, name)
        return model

    def __enter__(self):
        import torch
        from flexynesis_torch.ops import mlp

        self.orig = orig = mlp._HiddenStack.forward_with
        self.orig_mlp = orig_mlp = mlp.MLP.forward_with

        def mlp_forward_with(block, params, buffers, x, train, drop):
            key = self.names.get(id(block))
            if train and key is not None:
                with torch.no_grad():  # the block's BatchNorm output, running stats untouched
                    h = mlp.linear(x, params["layer_1.weight"], params["layer_1.bias"])
                    mu = h.mean(dim=-2, keepdim=True)
                    var = torch.clamp((h * h).mean(dim=-2, keepdim=True) - mu * mu, min=0.0)
                    h = ((h - mu) * torch.rsqrt(var + mlp.BN_EPS)
                         * params["batchnorm.weight"].unsqueeze(-2)
                         + params["batchnorm.bias"].unsqueeze(-2))
                self.signs.setdefault(key, []).append((h > 0).cpu())
            return orig_mlp(block, params, buffers, x, train, drop)

        mlp.MLP.forward_with = mlp_forward_with

        def forward_with(stack, params, buffers, x, train):
            key = self.names.get(id(stack))
            if train and key is not None:
                with torch.no_grad():
                    h = mlp.linear(x, params["dense_0.weight"], params["dense_0.bias"])
                self.signs.setdefault(key, []).append((h > 0).cpu())
            return orig(stack, params, buffers, x, train)

        mlp._HiddenStack.forward_with = forward_with
        return self

    def __exit__(self, *exc):
        from flexynesis_torch.ops import mlp

        mlp._HiddenStack.forward_with = self.orig
        mlp.MLP.forward_with = self.orig_mlp

    def units(self, a: str, k_a, b: str, k_b):
        """{stack: (steps in which each unit's pre-activations kept one sign
        over the batch in run ``a`` or run ``b``, steps in which a row's sign
        differs between the runs)}, each (H,), comparing trial ``k_a`` of run
        ``a`` with trial ``k_b`` of run ``b`` (None: a one-model run)."""
        out = {}
        for (tag, stack), seq in self.signs.items():
            if tag != a:
                continue
            other = self.signs[(b, stack)]
            if len(other) != len(seq):
                fail(f"pre-activations: {len(seq)} steps of {stack} in {a}, {len(other)} in {b}")
            one = cross = 0
            for sa, sb in zip(seq, other):
                sa = sa if k_a is None else sa[k_a]
                sb = sb if k_b is None else sb[k_b]
                one = one + (sa.all(0) | (~sa).all(0) | sb.all(0) | (~sb).all(0)).int()
                cross = cross + (sa != sb).any(0).int()
            out[stack] = (one, cross)
        return out


def _unit_of(name: str):
    """(hidden stack, axis of its unit in the leaf) of a VAE leaf that one
    hidden unit's entries make up: its stack's dense and BatchNorm entries
    (axis 0) and the heads that read the stack (``FC_mean``, ``FC_var``,
    ``FC_output`` weights, axis 1); likewise an MLP block's ``layer_1`` and
    ``batchnorm`` entries (axis 0) and its ``layer_out`` weight (axis 1),
    which count only where ``PreActs`` watched MLP blocks; None for every
    other leaf."""
    owner, sep, rest = name.partition(".hidden_layers.")
    if sep:
        return owner + ".hidden_layers", 0
    owner, _, leaf = name.rpartition(".")
    if leaf == "weight" and owner.endswith((".FC_mean", ".FC_var", ".FC_output")):
        return owner.rpartition(".")[0] + ".hidden_layers", 1
    for part, axis in ((".layer_1.", 0), (".batchnorm.", 0), (".layer_out.weight", 1)):
        block, sep, _ = name.partition(part)
        if sep:
            return block, axis
    return None


def _shift_atol(name: str, steps: int, lr: float, units=None):
    """The bound on a bias whose only effect is a constant shift of a
    batch-statistics BatchNorm's input: 2 x steps x lr for DirectPred's
    blocks' layer_1 bias, encoders' output bias and fusion bias (through
    linear layers) and the VAE heads' layer_1 bias; for the VAE's hidden
    stacks, 2 x lr for each step in which the unit's pre-activations kept
    one sign over the batch (LeakyReLU is linear there), per unit from
    ``units`` (``PreActs.units``; no allowance without it). Its gradient is
    zero in exact arithmetic, so two runs step on their own rounding noise,
    which Adam scales to about lr per step. A running mean takes the running
    average's share of such a shift, (1 - 0.9^steps) of it. None for every
    other entry."""
    run_share = 1 - (1 - 0.1) ** steps  # BN momentum 0.1
    if ".hidden_layers." in name:
        if units is None:
            return None
        one = units[_unit_of(name)[0]][0].float()
        if name.endswith("dense_0.bias"):
            return 2 * lr * one
        if name.endswith("bn_0.running_mean"):
            return run_share * 2 * lr * one
        return None
    if (name.endswith(("layer_1.bias", "layer_1_bias"))
            or name in ("fusion_block.bias", "encoder.fc.bias")
            or (name.startswith("encoder_") and name.endswith("layer_out.bias"))
            or (name.startswith("encoder.conv_") and name.endswith("bias"))):
        return 2 * steps * lr
    if name.endswith("running_mean"):
        return run_share * 2 * steps * lr
    return None


NOISE_SHARE = 1e-4  # of a VAE leaf, the most entries that may part outside a sign change
NOISE_PRINTED = 40  # noise entries printed per comparison


def adam_rms(r) -> dict:
    """{leaf: (K, ...) RMS of each entry's gradients so far} of a float32
    round ``r`` (Adam's bias-corrected sqrt(nu)), in the state-dict layout."""
    state = r.opt_state
    out = {}
    for n, v in zip(r.stacked.leaf_names, state.nu):
        v = (v.float() / (1 - 0.999 ** state.count)).sqrt()
        out[n] = v.mT if r.stacked.transposed[n] else v
    return out


def _state_err(got: dict, want: dict, lr: float, steps: int, what: str, noise=None,
               units=None, rms=None):
    """(max abs difference of two model states outside the shift-only
    entries, the largest shift-only difference as a share of its bound);
    fails outside rtol/atol 1e-4, plus the shift bound for shift-only
    entries (rtol 0 for the biases, per unit with ``units``). With
    ``noise``, a list the caller reports through ``noise_check``, an entry
    outside its tolerance passes if it is within 2 x steps x lr and either
    belongs to a hidden unit (``_unit_of``) whose pre-activations changed
    sign between the two runs in some step (``units``) or is one of at most
    max(1, NOISE_SHARE of its leaf) other such entries of its leaf; each is
    recorded there with its gradient RMS from ``rms`` ({leaf: tensor})."""
    import torch

    err, share = 0.0, 0.0
    for name, a in got.items():
        if name.endswith("num_batches_tracked"):
            continue
        b = want[name].to(a.device, a.dtype)
        gap = (a - b).abs()
        tol = TOL["atol"] + TOL["rtol"] * b.abs()
        shift = _shift_atol(name, steps, lr, units)
        if shift is not None:
            shift = torch.as_tensor(shift, dtype=a.dtype).to(a.device)
            if name.endswith("running_mean"):
                tol = tol + shift
            else:
                tol = torch.where(shift > 0, shift, tol)
            on = (shift > 0).expand_as(gap)
            if bool(on.any()):
                share = max(share, float((gap / shift.clamp_min(1e-30))[on].max()))
        close = gap <= tol
        far = ~close
        if bool(far.any()):
            idx = far.nonzero().cpu()
            gaps = gap[far].cpu()
            unit = _unit_of(name) if units is not None else None
            crossed = torch.zeros(len(idx), dtype=torch.int32)
            if unit is not None and unit[0] in units:
                crossed = units[unit[0]][1][idx[:, unit[1]]]
            g_rms = (rms[name][far].cpu() if rms is not None and name in rms
                     else torch.full((len(idx),), float("nan")))
            entries = [dict(what=what, name=name, index=i, gap=float(g), lr=lr, crossed=int(c),
                            rms=float(r)) for i, g, c, r in zip(idx.tolist(), gaps, crossed, g_rms)]
            free = [e for e in entries if not e["crossed"]]
            limit = max(1, int(NOISE_SHARE * a.numel()))
            bad = ([e for e in entries if e["gap"] > 2 * steps * lr]
                   + (free if len(free) > limit else []))
            if noise is None or bad:
                for e in (bad or entries)[:20]:
                    print(f"{what}: {e['name']}{e['index']} differs by {e['gap']:.3e} (sign "
                          f"changes of its unit between the runs: {e['crossed']} step(s); "
                          f"gradient RMS {e['rms']:.3e})", flush=True)
                fail(f"{what}: {len(entries)} of {a.numel()} entries of {name} differ "
                     f"beyond their tolerance, by up to {float(gaps.max()):.3e}"
                     + ("" if noise is None else
                        f"; {len(bad)} of them beyond 2 x steps x lr = {2 * steps * lr:.3e} "
                        f"or beyond the {limit} allowed outside units whose pre-activations "
                        "changed sign between the runs"))
            noise.extend(entries)
        if shift is None and bool(close.any()):
            err = max(err, float(gap[close].max()))
    return err, share


def noise_check(noise, what: str) -> str:
    """Prints every entry ``_state_err`` let take the noise bound and returns
    their summary. In the VAE a hidden unit whose pre-activations keep one
    sign over a batch has a dense bias that only shifts its BatchNorm's
    input, so its gradient is rounding noise and Adam steps it by about lr in
    a direction of its own in each run; once such a step carries a
    pre-activation across LeakyReLU's kink in one run and not in the other,
    the unit's gradients part, and Adam turns a parted gradient near zero
    into a step of up to lr. Elsewhere only an entry whose gradient is
    itself near zero, so that rounding steers its Adam step, may part: a few
    per leaf; a wrong step would move many."""
    # the entries outside units that changed sign first, up to NOISE_PRINTED
    ordered = ([e for e in noise if not e["crossed"]] + [e for e in noise if e["crossed"]])
    for e in ordered[:NOISE_PRINTED]:
        print(f"{what}: noise entry {e['what']}: {e['name']}{e['index']} differs by "
              f"{e['gap']:.3e} (lr {e['lr']:.3g}); sign changes of its unit between the runs "
              f"in {e['crossed']} step(s); gradient RMS {e['rms']:.3e}", flush=True)
    rest = ordered[NOISE_PRINTED:]
    if rest:
        print(f"{what}: {len(rest)} more noise entries not printed, "
              f"{sum(1 for e in rest if e['crossed'])} of them in units whose "
              "pre-activations changed sign between the runs", flush=True)
    kink = [e for e in noise if e["crossed"]]
    other = [e["rms"] for e in noise if not e["crossed"]]
    return (f"{len(noise)} entries beyond rtol/atol 1e-4, each within 2 x steps x lr: "
            f"{len(kink)} in units whose pre-activations changed sign between the runs, "
            f"{len(other)} elsewhere (at most max(1, {NOISE_SHARE:g} of the leaf) per leaf"
            + (f"; gradient RMS up to {max(other):.3e})" if other else ")"))


def shift_units(acts: PreActs, tag: str) -> str:
    """How many hidden units of run ``tag``'s trials kept one sign over
    the batch in a step (their dense bias only shifted the BatchNorm's
    input), of all the units times steps; empty without hidden stacks."""
    one = total = 0
    for (t, _), seq in acts.signs.items():
        if t == tag:
            for sa in seq:
                one += int((sa.all(-2) | (~sa).all(-2)).sum())
                total += sa.shape[0] * sa.shape[-1] if sa.dim() == 3 else sa.shape[-1]
    return (f"; hidden units keeping one sign over a step's batch: {one} of {total} "
            f"(units x trials x steps)" if total else "")


def _no_dropout(model):
    from flexynesis_torch.ops.fused_mlp import FusedMLP
    from flexynesis_torch.ops.graph_conv import FlexGCN
    from flexynesis_torch.ops.mlp import MLP

    for block in model.module.modules():
        if isinstance(block, (MLP, FusedMLP, FlexGCN)):
            block.dropout_rate = 0.0
    return model


def check_stacked_steps(config, cohort, model_name: str = "DirectPred",
                        lrs=(1e-4, 3e-4, 1e-3, 3e-3), noise: bool = False,
                        watch_mlp: bool = False):
    """Three stacked steps of K = len(lrs) trials (f32 parameters and
    moments, dropout 0, one initialisation, one lr each) against K unstacked
    Trainer steps (ClippedAdam) on the card, and against the same stacked
    steps on the CPU: losses rtol 1e-4, states rtol/atol 1e-4 (shift-only
    entries within their bound, the VAE's hidden stacks per unit from the
    signs of its pre-activations, recorded in every run). The noise (a VAE's
    eps and priors) comes from one CPU generator seeded alike on every side,
    the stacked trials sharing its draws as the trials of a same-architecture
    round do. With ``noise`` (the VAE, the triplet model, the GNN), entries
    may take ``noise_check``'s bound; ``watch_mlp`` records the MLP blocks'
    pre-activation signs too (``PreActs``)."""
    import torch
    from flexynesis_torch.models import MODEL_REGISTRY
    from flexynesis_torch.parallel.stacked import TrialNoise, stacked_model
    from flexynesis_torch.parallel.trials import _Round, _gather
    from flexynesis_torch.train.trainer import Trainer, gather

    K, steps = len(lrs), 3
    lrs = list(lrs)

    def model_on(device):
        m = MODEL_REGISTRY[model_name](config, cohort, target_variables=["subtype"],
                                       device=device)
        m.init_params(seed=3)
        return _no_dropout(m)

    perm = torch.randperm(model_on("cpu").n_train_samples(cohort),
                          generator=torch.Generator().manual_seed(5))
    perm = perm[: steps * BATCH].reshape(steps, BATCH)
    stacked_runs, acts = {}, PreActs(mlp=watch_mlp)
    for tag, device in (("card", DEVICE), ("cpu", "cpu")):
        m = acts.watch(model_on(device), tag)
        stacked = stacked_model(m, K)
        state = {n: t.clone() for n, t in m.module.state_dict().items()}
        params, buffers = stacked.stack([state] * K)
        trial_round = _Round(m, params, buffers, lrs=lrs, seeds=[0] * K,
                             param_dtype="float32")
        trial_round.noise = TrialNoise(torch.Generator().manual_seed(0), [0] * K)
        data = m.make_batch(cohort)
        with acts:
            losses = [trial_round.step(_gather(data, p.to(device))).cpu() for p in perm]
        states = [stacked.trial_state(trial_round.params, trial_round.buffers, k)
                  for k in range(K)]
        stacked_runs[tag] = (torch.stack(losses), states, adam_rms(trial_round))

    singles = []
    for k in range(K):
        m = acts.watch(model_on(DEVICE), f"single{k}")
        data = m.make_batch(cohort)
        trainer = Trainer(m.module, m.loss_fn, lr=lrs[k])
        gen = torch.Generator().manual_seed(0)
        with acts:
            losses = [float(trainer.train_step(gather(data, p.to(DEVICE)), gen)) for p in perm]
        singles.append((losses, {n: t.detach() for n, t in m.module.state_dict().items()}))

    card_losses, card_states, card_rms = stacked_runs["card"]
    single_losses = torch.tensor([s[0] for s in singles]).T
    if not torch.allclose(card_losses, single_losses, rtol=1e-4, atol=0):
        fail(f"stacked steps: losses {card_losses.tolist()} differ from the single-trial "
             f"Trainer's {single_losses.tolist()} (rtol 1e-4)")
    noise_single, noise_cpu = ([], []) if noise else (None, None)
    err_single, share_single = map(max, zip(*(
        _state_err(card_states[k], singles[k][1], lrs[k], steps,
                   f"stacked trial {k} against its Trainer", noise_single,
                   acts.units("card", k, f"single{k}", None),
                   {n: t[k] for n, t in card_rms.items()}) for k in range(K))))
    cpu_losses, cpu_states, _ = stacked_runs["cpu"]
    if not torch.allclose(card_losses, cpu_losses, rtol=1e-4, atol=0):
        fail(f"stacked steps: card losses {card_losses.tolist()} differ from the CPU's "
             f"{cpu_losses.tolist()} (rtol 1e-4)")
    err_cpu, share_cpu = map(max, zip(*(
        _state_err(card_states[k], cpu_states[k], lrs[k], steps,
                   f"stacked trial {k} card against cpu", noise_cpu,
                   acts.units("card", k, "cpu", k),
                   {n: t[k] for n, t in card_rms.items()}) for k in range(K))))
    noted = ""
    if noise:
        noted = (f"; against the Trainer {noise_check(noise_single, 'stacked against Trainer')}"
                 f", against the CPU {noise_check(noise_cpu, 'stacked card against cpu')}")
    print(f"trials: {model_name}: {steps} stacked steps of K={K} (lrs {[f'{v:.3g}' for v in lrs]}, "
          "f32 parameters and moments) "
          f"equal {K} Trainer steps on the card: losses max rel diff "
          f"{float(((card_losses - single_losses) / single_losses).abs().max()):.3e}, states "
          f"max abs diff {err_single:.3e}; and the CPU: losses max rel diff "
          f"{float(((card_losses - cpu_losses) / cpu_losses).abs().max()):.3e}, states "
          f"{err_cpu:.3e} (rtol/atol 1e-4); shift-only entries at most {share_single:.3f} "
          f"and {share_cpu:.3f} of their bounds (biases 2 x lr per step that shifts them, "
          f"running means (1 - 0.9^steps) of that){noted}{shift_units(acts, "card")}",
          flush=True)


# four suggestions of the default DirectPred space, padded into one round
MIXED_GROUP = [
    {"latent_dim": 64, "hidden_dim_factor": 0.3, "supervisor_hidden_dim": 16, "lr": 1e-3},
    {"latent_dim": 128, "hidden_dim_factor": 0.5, "supervisor_hidden_dim": 32, "lr": 3e-3},
    {"latent_dim": 32, "hidden_dim_factor": 0.2, "supervisor_hidden_dim": 8, "lr": 3e-4},
    {"latent_dim": 96, "hidden_dim_factor": 0.4, "supervisor_hidden_dim": 24, "lr": 1e-4},
]


def _sr_rounds(config, cohort, device):
    """{name: (round, per-step SR seeds)} of the two SR-bf16 rounds of
    check_sr_steps on ``device``, dropout 0: a same-architecture round of
    K = 4 trials from one initialisation (fused, one SR seed for all trials)
    and the padded round of MIXED_GROUP (unfused, a seed per trial, element
    masks)."""
    import numpy as np
    import torch
    from flexynesis_torch.models.direct_pred import DirectPred
    from flexynesis_torch.parallel.hetero import build_padded_trials, max_config
    from flexynesis_torch.parallel.trials import _init_stacked, _Round

    K = len(MIXED_GROUP)
    lrs = [c["lr"] for c in MIXED_GROUP]
    seeds = np.arange(3, 3 + K)

    def model(cfg):
        return _no_dropout(DirectPred(cfg, cohort, target_variables=["subtype"], device=device))

    same = model(config)
    params, buffers = _init_stacked(same, [3] * K)
    dims = [len(cohort.features[k]) for k in cohort.dat]
    group = [dict(config, fused_kernels=False, **c) for c in MIXED_GROUP]
    padded = model(max_config(group, dims))
    trials = build_padded_trials(padded, group, seeds)

    def sr_seeds(n):  # per step, near 2^32 so the seed mixing wraps
        return [torch.tensor([2 ** 32 - 1 - 97 * s - t for t in range(n)]) for s in range(3)]

    return {"same-architecture": (_Round(same, params, buffers, lrs=lrs, seeds=[3] * K),
                                  sr_seeds(1)),
            "padded": (_Round(padded, trials["params"], trials["buffers"], lrs=lrs,
                              seeds=seeds, masks=trials["masks"]), sr_seeds(K))}


def _bf16_ulps(a, b, pad):
    """|a - b| in bfloat16 ulps of max(|a|, |b|) + pad, elementwise."""
    import torch

    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    _, e = torch.frexp(torch.maximum(a.abs(), b.abs()) + pad)
    return (a - b).abs() / torch.exp2((e - 8).float())


def _bits(t):
    import torch

    t = t.detach().cpu().contiguous()
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _padded_zero(trial_round, what: str) -> None:
    """Fails unless every masked-out parameter entry is exactly zero."""
    for view, m in zip(trial_round.views, trial_round.masks):
        if bool(((view.float() * (1 - m)) != 0).any()):
            fail(f"{what}: a padded entry left zero")


def check_sr_steps(config, cohort):
    """SR-bf16 Adam, the trial rounds' optimizer, on the card against the
    CPU with the same fixed SR seeds (the two devices' generators draw
    different streams). (1) ``sr_adam_step`` on the same (K, ...) leaves,
    masks and gradients, three steps, parameters and moments bit for bit:
    unclipped on 1e-5 x N(0, 1) gradients, and clipped on gradients of
    +-2^-4 or 0, whose squares sum exactly in any order, so that both
    devices clip by the same scale. (2) Three SR-bf16 stacked steps of each
    round of ``_sr_rounds`` on the cohort, where the gradients differ in
    their last bits between the devices: losses rtol 1e-4; bfloat16 leaves:
    at most 1% of the entries differ (the same SR bits round almost every
    entry alike; a wrong seed or hash would change about half), and each
    within 3 bfloat16 ulps of max(|card|, |cpu|) + 3 x the trial's lr (each
    step's stochastic rounding may land one ulp apart at the value's
    magnitude during the steps, which steps of about lr keep within 3 x lr
    of the final value's), except at most 1e-4 of the entries, whose
    gradient is rounding noise (as a shift-only bias's), within 2 x 3 x lr;
    float32 leaves and running statistics rtol/atol 1e-4 (shift-only entries
    within their bound); the padded entries exactly zero on both devices."""
    import torch
    from flexynesis_torch.ops.sr_adam import sr_adam_init, sr_adam_step
    from flexynesis_torch.parallel.trials import _gather

    rounds = {"card": _sr_rounds(config, cohort, DEVICE),
              "cpu": _sr_rounds(config, cohort, "cpu")}
    gen = torch.Generator().manual_seed(11)
    for name, (card_round, seeds) in rounds["card"].items():
        cpu_round = rounds["cpu"][name][0]
        n_bf16 = sum(v.dtype == torch.bfloat16 for v in card_round.views)
        if n_bf16 == 0:
            fail(f"trials: the {name} round stores no leaf in bfloat16")
        for clipped in (False, True):
            runs = {}
            grads = []
            for _ in seeds:
                g = [torch.randn(v.shape, generator=gen) for v in cpu_round.views]
                if clipped:  # exact squares: each trial's norm is one value on both devices
                    g = [torch.sign(x) * (x.abs() > 0.5) * 2.0 ** -4 for x in g]
                else:  # a per-trial norm near 0.02: the clip scale is exactly 1
                    g = [x * 1e-5 for x in g]
                grads.append(g)
            for side, r in (("card", card_round), ("cpu", cpu_round)):
                leaves = [v.detach().clone() for v in r.views]
                state = sr_adam_init(leaves)
                for g, seed in zip(grads, seeds):
                    leaves, state = sr_adam_step(
                        leaves, state, [x.to(r.device) for x in g], r.lrs, seed.to(r.device),
                        masks=r.masks, trial_axis=True)
                runs[side] = [*leaves, *state.m, *state.v]
            for i, (a, b) in enumerate(zip(runs["card"], runs["cpu"])):
                if not torch.equal(_bits(a), _bits(b)):
                    fail(f"trials: {name} sr_adam_step ({'clipped' if clipped else 'unclipped'})"
                         f": leaf {i} of (parameters, m, v) differs between card and CPU, max "
                         f"abs {float((a.cpu().float() - b.float()).abs().max()):.3e}")
        print(f"trials: sr_adam_step ({name}, K={card_round.K}, {n_bf16} bfloat16 leaves"
              f"{', masked' if card_round.masks else ''}): card = CPU bit for bit over 3 "
              "steps, unclipped and clipped", flush=True)

    perm = torch.randperm(len(cohort), generator=torch.Generator().manual_seed(6))
    perm = perm[: 3 * BATCH].reshape(3, BATCH)
    for name, (card_round, seeds) in rounds["card"].items():
        cpu_round = rounds["cpu"][name][0]
        losses = {}
        for side, r in (("card", card_round), ("cpu", cpu_round)):
            data = r.model.make_batch(cohort)
            losses[side] = torch.stack([
                r.step(_gather(data, p.to(r.device)), seed.to(r.device)).cpu()
                for p, seed in zip(perm, seeds)])
            if r.masks is not None:
                _padded_zero(r, f"trials: {name} SR-bf16 steps on the {side}")
        if not torch.allclose(losses["card"], losses["cpu"], rtol=1e-4, atol=0):
            fail(f"trials: {name} SR-bf16 steps: card losses {losses['card'].tolist()} "
                 f"differ from the CPU's {losses['cpu'].tolist()} (rtol 1e-4)")
        worst, err, share = 0.0, 0.0, 0.0
        for k in range(card_round.K):
            lr = float(card_round.lrs[k])
            got = {**{n: t[k] for n, t in card_round.params.items()
                      if t.dtype != torch.bfloat16},
                   **{n: t[k] for n, t in card_round.buffers.items()}}
            want = {n: t[k] for n, t in {**cpu_round.params, **cpu_round.buffers}.items()}
            e, sh = _state_err(got, want, lr, 3, f"trials: {name} SR-bf16 trial {k} card "
                                                   "against cpu")
            err, share = max(err, e), max(share, sh)
        n_diff = n_all = n_noise = 0
        for n, t in card_round.params.items():
            if t.dtype != torch.bfloat16:
                continue
            want = cpu_round.params[n]
            lr = card_round.lrs.cpu().reshape((-1,) + (1,) * (t.dim() - 1))
            ulps = _bf16_ulps(t, want, 3 * lr)
            n_diff += int((ulps > 0).sum())
            n_all += ulps.numel()
            noise = ulps > 3
            n_noise += int(noise.sum())
            worst = max(worst, float(torch.where(noise, 0.0, ulps).max()))
            gap = (t.detach().float().cpu() - want.float()).abs()
            if bool((gap > 6 * lr)[noise].any()):
                i = int(torch.where(noise, gap / (6 * lr), 0).argmax())
                k = i // (ulps.numel() // t.shape[0])
                fail(f"trials: {name} SR-bf16 steps: {n} differs by {float(gap.flatten()[i])} "
                     f"between card and CPU, beyond 3 bfloat16 ulps and 2 x 3 x lr: trial {k} "
                     f"(lr {float(lr.flatten()[k]):.3g}), {float(t.flatten()[i])} against "
                     f"{float(want.flatten()[i])}")
        if n_diff > 0.01 * n_all or n_noise > 1e-4 * n_all:
            fail(f"trials: {name} SR-bf16 steps: {n_diff} of {n_all} bfloat16 entries differ "
                 f"between card and CPU (at most 1%), {n_noise} beyond 3 ulps (at most 1e-4)")
        print(f"trials: 3 SR-bf16 stacked steps ({name}, K={card_round.K}) card against CPU: "
              f"losses max rel diff "
              f"{float(((losses['card'] - losses['cpu']) / losses['cpu']).abs().max()):.3e}, "
              f"{n_diff} of {n_all} bfloat16 entries differ, by at most {worst:.2f} ulps "
              f"({n_noise} noise entries beyond 3 ulps, within 2 x 3 x lr), "
              f"float32 leaves and statistics max "
              f"abs diff {err:.3e}, shift-only entries at most {share:.3f} of their bounds"
              f"{'; padded entries exactly zero' if card_round.masks else ''}", flush=True)


def time_stacked_steps(config, cohort, K: int = TRIALS, model_name: str = "DirectPred"):
    """Median host-clock time of one stacked training step of K trials (the
    same-architecture round's engine: SR-bf16 Adam, one seed) and a profiled
    run of PROFILED_STEPS such steps with its device-busy share. Returns
    (the median in ms, the busy share in percent or None)."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from flexynesis_torch.models import MODEL_REGISTRY
    from flexynesis_torch.parallel.trials import _gather, _init_stacked, _Round

    m = MODEL_REGISTRY[model_name](config, cohort, target_variables=["subtype"], device=DEVICE)
    params, buffers = _init_stacked(m, np.zeros(K, np.int64))
    trial_round = _Round(m, params, buffers, lrs=np.geomspace(1e-4, 1e-2, K), seeds=[0] * K)
    data = m.make_batch(cohort)
    n = m.n_train_samples(cohort)
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(9))
    batches = [_gather(data, perm[i:i + BATCH].to(DEVICE))
               for i in range(0, n - BATCH + 1, BATCH)]
    for b in batches[:3]:
        trial_round.step(b)
    times = []
    for i in range(30):
        torch.cuda.synchronize()
        t = time.perf_counter()
        trial_round.step(batches[i % len(batches)])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    med = statistics.median(times)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        for b in batches[:PROFILED_STEPS]:
            trial_round.step(b)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    print(f"trials: {model_name}: stacked step of K={K} (SR-bf16 Adam, batch {BATCH}) x30: median "
          f"{med * 1e3:.3f} ms (min {min(times) * 1e3:.3f}, max {max(times) * 1e3:.3f}; host "
          f"clock, synchronised), {K * BATCH / med:.0f} trial-samples/s", flush=True)
    device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in device)
    busy = None
    if busy_us > 0:
        busy = 100 * busy_us / wall_us
        top = sorted(device, key=lambda e: -e.self_device_time_total)[:8]
        print(f"trials: {model_name}: profiled {PROFILED_STEPS} stacked steps: wall {wall_us:.0f} us, device "
              f"busy {busy_us:.0f} us ({100 * busy_us / wall_us:.1f}%), "
              f"{sum(e.count for e in device) / PROFILED_STEPS:.0f} device operations per step; "
              "top: " + "; ".join(f"{e.key[:48]} {e.self_device_time_total:.0f} us"
                                  for e in top), flush=True)
        print("trials: the port's kernels per stacked step (device time): "
              + port_kernels(device, PROFILED_STEPS), flush=True)
    else:
        print("trials: profiled stacked steps: the profiler saw no device time (not measured)")
    return med * 1e3, busy


TRIAL_CONFIG = """DirectPred:
  - {type: Categorical, categories: [%d], name: latent_dim}
  - {type: Categorical, categories: [%s], name: hidden_dim_factor}
  - {type: Real, low: 0.0001, high: 0.01, prior: log-uniform, name: lr}
  - {type: Categorical, categories: [%d], name: supervisor_hidden_dim}
  - {type: Categorical, categories: [%d], name: epochs}
  - {type: Categorical, categories: [%d], name: batch_size}
  - {type: Categorical, categories: [true], name: fused_kernels}
"""
# the default DirectPred space (flexynesis_torch/config.py) with epochs and
# batch size fixed, fused_kernels off: every suggestion lands in one bucket
MIXED_EPOCHS = 5
MIXED_CONFIG = """DirectPred:
  - {type: Integer, low: 16, high: 128, quantize: 16, name: latent_dim}
  - {type: Real, low: 0.2, high: 0.5, name: hidden_dim_factor}
  - {type: Real, low: 0.0001, high: 0.01, prior: log-uniform, name: lr}
  - {type: Integer, low: 8, high: 32, quantize: 8, name: supervisor_hidden_dim}
  - {type: Categorical, categories: [%d], name: epochs}
  - {type: Categorical, categories: [%d], name: batch_size}
"""


def hpo_run(workdir: Path, name: str, config_text: str, extra=(), model_class="DirectPred",
            n_iter=None, data=None):
    """One training CLI run of ``n_iter`` GP suggestions of ``model_class``
    on phase 5's folder (or ``data``); returns (model, its CLI phases, (B1, B2, B3)
    launches, the log, the output folder) and prints the peak of the card's
    allocated memory."""
    import torch
    from flexynesis_torch.__main__ import parse_args, run_training
    from flexynesis_torch.kernels.fused_linear import (
        fused_linear_bn_relu as b1,
        fused_linear_bn_relu_eval as b2,
    )
    from flexynesis_torch.kernels.mmd import gaussian_kernel_mean as b3

    config = workdir / f"{name}.yaml"
    config.write_text(config_text)
    out = workdir / f"{name}_out"
    args = train_args(data or workdir / "fit_data", config, out, DEVICE, model_class)
    n_iter = n_iter or TRIALS
    args[args.index("--hpo_iter") + 1] = str(n_iter)
    torch.cuda.reset_peak_memory_stats()
    b1.launches = b2.launches = b3.launches = 0
    with Tee() as log:
        model = run_training(*parse_args([*args, *extra]))
    launches = (b1.launches, b2.launches, b3.launches)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    missing = [f for f in ("fit.stats.csv", "fit.predicted_labels.csv", "fit.embeddings_test.csv",
                           "fit.final_model.safetensors") if not (out / f).exists()]
    if missing:
        fail(f"trials: the {name} CLI run did not write {missing}")
    phases = model.cli_phases
    print(f"trials: {name}: CLI phases (host clock, s): "
          + json.dumps({k: round(v, 4) for k, v in phases.items()})
          + f"; {n_iter} trials in hpo_fit: {n_iter / phases['hpo_fit'] * 3600:.0f} trials/h; "
          f"launches B1 {launches[0]}, B2 {launches[1]}, B3 {launches[2]}; peak allocated "
          f"on the card {peak_gib:.3f} GiB", flush=True)
    return model, phases, launches, log.text, out


def train_trials(workdir: Path, importer_cache: ImportOnce, cohort):
    """The trial phase on phase 5's folder: the stacked steps against single
    trials, one stacked step's time and profile, a same-architecture round of
    TRIALS suggestions through the CLI (--hpo_batch 0, fused kernels) against
    the same TRIALS trials one at a time (--hpo_batch 1), and a
    mixed-architecture round (default space, fused off). Returns the
    launches (B1, B2) of each CLI run and the summary numbers."""
    import numpy as np
    from flexynesis_torch.__main__ import main as cli

    h_config = {"latent_dim": LATENT, "hidden_dim_factor": HIDDEN_FACTOR,
                "supervisor_hidden_dim": SUP_HIDDEN, "lr": 1e-3, "epochs": FIT_EPOCHS,
                "batch_size": BATCH, "fused_kernels": True}
    check_stacked_steps(h_config, cohort)
    check_sr_steps(h_config, cohort)
    step_ms, busy = time_stacked_steps(h_config, cohort)

    same = TRIAL_CONFIG % (LATENT, HIDDEN_FACTOR, SUP_HIDDEN, FIT_EPOCHS, BATCH)
    with importer_cache:
        model, phases, launches, log, out = hpo_run(workdir, "hpo_batched", same)
        seq_model, seq_phases, seq_launches, _, _ = hpo_run(
            workdir, "hpo_sequential", same, ("--hpo_batch", "1"))
        mixed, mixed_phases, mixed_launches, mixed_log, _ = hpo_run(
            workdir, "hpo_mixed", MIXED_CONFIG % (MIXED_EPOCHS, BATCH))

    if f"HPO trial fan-out: {TRIALS} suggestions per GP round" not in log:
        fail(f"trials: --hpo_batch 0 did not resolve to {TRIALS} on the card")
    if f"Training {TRIALS} same-architecture trials concurrently (stacked)" not in log:
        fail("trials: the same-architecture round did not train stacked")
    n = FIT_TRAIN
    n_fit = n - int(np.ceil(n * VAL_SIZE))
    round_steps = FIT_EPOCHS * (n_fit // BATCH)  # patience 10 > 10 epochs: no early stop
    retrain_steps = model.train_result.epochs_run * (n // BATCH)
    want = (B1_PER_STEP * (round_steps + retrain_steps),
            B2_PER_FORWARD * (FIT_EPOCHS + EVAL_FORWARDS), 0)
    if launches != want:
        fail(f"trials: batched round launches (B1, B2) = {launches}, expected {want}: "
             f"{B1_PER_STEP} per stacked step x ({round_steps} round steps + {retrain_steps} "
             f"retrain steps), {B2_PER_FORWARD} per eval forward x ({FIT_EPOCHS} stacked "
             f"validations + {EVAL_FORWARDS} evaluation forwards)")
    seq_want = (B1_PER_STEP * TRIALS * round_steps,
                B2_PER_FORWARD * (TRIALS * FIT_EPOCHS + EVAL_FORWARDS), 0)
    if seq_launches != seq_want:
        fail(f"trials: sequential launches (B1, B2) = {seq_launches}, expected {seq_want}")
    print(f"trials: {TRIALS} trials batched: B1 {launches[0]} launches = {B1_PER_STEP} x "
          f"({round_steps} stacked steps + {retrain_steps} retrain steps), B2 {launches[1]}; "
          f"one at a time: B1 {seq_launches[0]} = {B1_PER_STEP} x {TRIALS} x {round_steps}, "
          f"B2 {seq_launches[1]}", flush=True)

    # the retrained best model serves alike on the card and on the CPU
    data = workdir / "fit_data"
    for device in (DEVICE, "cpu"):
        if cli(["--pretrained_model", str(out / "fit.final_model.safetensors"),
                "--artifacts", str(out / "fit.artifacts.json"),
                "--data_path_test", str(data / "test"),
                "--outdir", str(workdir / f"hpo_served_{device}"),
                "--prefix", "smoke", "--disable_marker_finding", "--device", device]) != 0:
            fail(f"trials: serving the batched round's model on {device} returned nonzero")
    encoder = json.loads((out / "fit.artifacts.json").read_text())["label_encoders"]["subtype"]
    compare_outputs(workdir / f"hpo_served_{DEVICE}", workdir / "hpo_served_cpu", FIT_TEST,
                    len(encoder["categories"][0]), "trials: the batched round's model served")

    if f"Training {TRIALS} mixed-architecture trials concurrently (padded, stacked)" \
            not in mixed_log:
        fail("trials: the mixed round did not take the padded path")
    if "Final full-data training with best params" not in mixed_log:
        fail("trials: the mixed round did not retrain its best configuration")
    if mixed_launches != (0, 0, 0):
        fail(f"trials: the unfused mixed round launched B1/B2/B3 {mixed_launches} times")
    rate = {k: TRIALS / p["hpo_fit"] * 3600
            for k, p in (("batched", phases), ("sequential", seq_phases),
                         ("mixed", mixed_phases))}
    print(f"trials: hpo_fit trials/h: batched {rate['batched']:.0f}, one at a time "
          f"{rate['sequential']:.0f} ({rate['batched'] / rate['sequential']:.2f}x), mixed "
          f"architectures ({MIXED_EPOCHS} epochs, unfused) {rate['mixed']:.0f}; best "
          f"val-chosen lr batched {model.config['lr']:.3g}, sequential "
          f"{seq_model.config['lr']:.3g}", flush=True)
    return ({"hpo_batched": launches, "hpo_sequential": seq_launches,
             "hpo_mixed": mixed_launches},
            {"trials_per_hour": rate, "stacked_step_ms": step_ms, "stacked_busy_pct": busy})


# the VAE phases' HPO space: the headline architecture fixed, lr free
VAE_TRIAL_CONFIG = TRIAL_CONFIG.replace("DirectPred:", "supervised_vae:")
VAE_TRIAL_EPOCHS = 5  # the batched and one-at-a-time VAE rounds, cut alike
CV_SUGGESTIONS, CV_FOLDS, CV_EPOCHS = 4, 5, 3
# a default-space CrossModalPred round with fused_kernels on: padded, so
# its trials take the masked MMD and B3 runs only in the final retrain
CM_MIXED_CONFIG = MIXED_CONFIG.replace("DirectPred:", "CrossModalPred:") + \
    "  - {type: Categorical, categories: [true], name: fused_kernels}\n"
# four supervised_vae suggestions padded into one round (fused_kernels on)
VAE_MIXED_GROUP = [
    {"latent_dim": 64, "hidden_dim_factor": 0.3, "supervisor_hidden_dim": 16, "lr": 1e-3},
    {"latent_dim": 96, "hidden_dim_factor": 0.4, "supervisor_hidden_dim": 24, "lr": 3e-4},
    {"latent_dim": 32, "hidden_dim_factor": 0.2, "supervisor_hidden_dim": 8, "lr": 3e-3},
    {"latent_dim": 16, "hidden_dim_factor": 0.5, "supervisor_hidden_dim": 32, "lr": 1e-4},
]


def _round_pair(build, what: str, steps_of):
    """Float32 stacked steps of the round ``build(device)`` returns ((round,
    rows per step)) on the card and on the CPU, the noise from one CPU
    generator on both (per trial where the round's seeds differ): losses
    rtol 1e-4, states rtol/atol 1e-4 (shift-only entries within their bound,
    the VAE's rounding-noise entries as ``noise_check`` allows), masked
    entries exactly zero. ``steps_of`` gives the batch of a
    step's rows. Returns (loss rel diff, state abs diff, B3 launches on the
    card)."""
    import torch
    from flexynesis_torch.kernels.mmd import gaussian_kernel_mean as b3
    from flexynesis_torch.parallel.stacked import TrialNoise

    runs, b3_card, acts = {}, 0, PreActs()
    for tag, device in (("card", DEVICE), ("cpu", "cpu")):
        r, rows = build(device)
        acts.watch(r.model, tag)
        r.noise = TrialNoise(torch.Generator().manual_seed(0), r.seeds)
        before = b3.launches
        with acts:
            losses = torch.stack([r.step(steps_of(r, p)).cpu() for p in rows])
        if tag == "card":
            torch.cuda.synchronize()
            b3_card = b3.launches - before
        if r.masks is not None:
            _padded_zero(r, f"{what} on the {device}")
        runs[tag] = (r, losses)
    (card, l_card), (cpu, l_cpu) = runs["card"], runs["cpu"]
    if not torch.allclose(l_card, l_cpu, rtol=1e-4, atol=0):
        fail(f"{what}: card losses {l_card.tolist()} differ from the CPU's {l_cpu.tolist()}")
    err, share, noise, rms = 0.0, 0.0, [], adam_rms(card)
    for k in range(card.K):
        got = {n: t[k] for n, t in {**card.params, **card.buffers}.items()}
        want = {n: t[k] for n, t in {**cpu.params, **cpu.buffers}.items()}
        e, sh = _state_err(got, want, float(card.lrs[k]), len(l_card), f"{what} trial {k}",
                           noise, acts.units("card", k, "cpu", k),
                           {n: t[k] for n, t in rms.items()})
        err, share = max(err, e), max(share, sh)
    rel = float(((l_card - l_cpu) / l_cpu).abs().max())
    print(f"{what}: {len(l_card)} stacked steps of K={card.K} card against CPU: losses max rel "
          f"diff {rel:.3e}, states max abs diff {err:.3e} (rtol/atol 1e-4; "
          f"{noise_check(noise, what)}), shift-only entries at most {share:.3f} of their bounds"
          f"{'; masked entries exactly zero' if card.masks is not None else ''}; "
          f"B3 launches on the card {b3_card}{shift_units(acts, "card")}", flush=True)
    return rel, err, b3_card


def check_vae_rounds(config, cohort):
    """The VAE's padded and CV rounds on the card against the CPU: a padded
    round of VAE_MIXED_GROUP (element masks and ``_aux``, so the masked
    plain MMD and no B3, the noise drawn per trial) and one stacked step of
    a CV round of CV_SUGGESTIONS x CV_FOLDS trials (each trial its fold's
    rows and its own prior, B3 reading the prior at its trial stride)."""
    import numpy as np
    import torch
    from flexynesis_torch.models.supervised_vae import SupervisedVAE
    from flexynesis_torch.parallel.hetero import build_padded_trials, max_config
    from flexynesis_torch.parallel.trials import (
        _gather, _init_stacked, _Round, equal_kfold_indices,
    )

    dims = [len(cohort.features[k]) for k in cohort.dat]
    group = [dict(config, **c) for c in VAE_MIXED_GROUP]
    perm = torch.randperm(len(cohort), generator=torch.Generator().manual_seed(6))
    perm = perm[: 3 * BATCH].reshape(3, BATCH)

    def padded(device):
        m = _no_dropout(SupervisedVAE(max_config(group, dims), cohort,
                                      target_variables=["subtype"], device=device))
        trials = build_padded_trials(m, group, np.arange(3, 3 + len(group)))
        r = _Round(m, trials["params"], trials["buffers"], lrs=[c["lr"] for c in group],
                   seeds=np.arange(3, 3 + len(group)), masks=trials["masks"],
                   aux=trials["aux"], param_dtype="float32")
        return r, perm

    def by_rows(r, p):
        return _gather(r.model.make_batch(cohort), p.to(r.device))

    _, _, b3_padded = _round_pair(padded, "vae rounds: padded supervised_vae", by_rows)
    if b3_padded:
        fail(f"vae rounds: the padded round launched B3 {b3_padded} times (masked MMD expected)")

    K = CV_SUGGESTIONS * CV_FOLDS
    tr, _ = equal_kfold_indices(len(cohort), CV_FOLDS, seed=42)
    train_idx = np.tile(tr, (CV_SUGGESTIONS, 1))
    seeds = np.tile(np.arange(42, 42 + CV_FOLDS), CV_SUGGESTIONS)

    def cv(device):
        m = _no_dropout(SupervisedVAE(config, cohort, target_variables=["subtype"],
                                      device=device))
        params, buffers = _init_stacked(m, seeds)
        r = _Round(m, params, buffers, lrs=np.repeat([1e-4, 3e-4, 1e-3, 3e-3], CV_FOLDS),
                   seeds=seeds, param_dtype="float32")
        return r, [r.epoch_rows(train_idx, 1, BATCH)[0].cpu()]

    _, _, b3_cv = _round_pair(cv, "vae rounds: one CV step", by_rows)
    n_dec = len(cohort.dat)
    if b3_cv != n_dec:
        fail(f"vae rounds: the CV step launched B3 {b3_cv} times, expected {n_dec} (one per "
             "decoded layer for all trials)")


def vae_trials(workdir: Path, importer_cache: ImportOnce, cohort):
    """The VAE-MMD trial engine and the CV fold engine on phase 5's folder:
    16 stacked supervised_vae steps against 16 single trials and the CPU,
    the padded and CV rounds against the CPU, one stacked step's time and
    profile; then through the training CLI: a supervised_vae round of TRIALS
    suggestions (``--hpo_batch 0``, lr free, fused) against the same trials
    one at a time, a mixed-architecture CrossModalPred round (default space,
    fused, padded), and ``--use_cv`` rounds of CV_SUGGESTIONS x CV_FOLDS
    trials of DirectPred and supervised_vae (fused). Returns each CLI run's
    (B1, B2, B3) launches and the summary numbers."""
    import numpy as np

    config = {"latent_dim": LATENT, "hidden_dim_factor": HIDDEN_FACTOR,
              "supervisor_hidden_dim": SUP_HIDDEN, "lr": 1e-3, "epochs": VAE_TRIAL_EPOCHS,
              "batch_size": BATCH, "fused_kernels": True}
    check_stacked_steps(config, cohort, "supervised_vae", np.geomspace(1e-4, 3e-3, TRIALS),
                        noise=True)
    check_vae_rounds(config, cohort)
    step_ms, busy = time_stacked_steps(config, cohort, TRIALS, "supervised_vae")

    n = FIT_TRAIN
    n_fit = n - int(np.ceil(n * VAL_SIZE))
    n_dec = 2  # gex and cnv
    vae_same = VAE_TRIAL_CONFIG % (LATENT, HIDDEN_FACTOR, SUP_HIDDEN, VAE_TRIAL_EPOCHS, BATCH)
    cm = ("--input_layers", "gex", "--output_layers", "cnv")
    with importer_cache:
        model, phases, launches, log, _ = hpo_run(workdir, "vae_batched", vae_same,
                                                  model_class="supervised_vae")
        _, seq_phases, seq_launches, _, _ = hpo_run(
            workdir, "vae_sequential", vae_same, ("--hpo_batch", "1"), "supervised_vae")
        cm_model, cm_phases, cm_launches, cm_log, _ = hpo_run(
            workdir, "cm_mixed", CM_MIXED_CONFIG % (CM_EPOCHS, BATCH), cm, "CrossModalPred")
        cv_same = TRIAL_CONFIG % (LATENT, HIDDEN_FACTOR, SUP_HIDDEN, CV_EPOCHS, BATCH)
        cv_dp, _, cv_dp_launches, cv_dp_log, _ = hpo_run(
            workdir, "cv_directpred", cv_same, ("--use_cv",), n_iter=CV_SUGGESTIONS)
        cv_vae, _, cv_vae_launches, cv_vae_log, _ = hpo_run(
            workdir, "cv_vae", cv_same.replace("DirectPred:", "supervised_vae:"), ("--use_cv",),
            "supervised_vae", CV_SUGGESTIONS)

    if f"HPO trial fan-out: {TRIALS} suggestions per GP round" not in log:
        fail(f"vae trials: --hpo_batch 0 did not resolve to {TRIALS} for supervised_vae")
    if f"Training {TRIALS} same-architecture trials concurrently (stacked)" not in log:
        fail("vae trials: the supervised_vae round did not train stacked")
    round_steps = VAE_TRIAL_EPOCHS * (n_fit // BATCH)  # patience 10: no early stop
    retrain_steps = model.train_result.epochs_run * (n // BATCH)
    want = (0, 0, n_dec * (round_steps + VAE_TRIAL_EPOCHS + retrain_steps))
    if launches != want:
        fail(f"vae trials: batched round launches (B1, B2, B3) = {launches}, expected {want}: "
             f"{n_dec} decoded layers x ({round_steps} stacked steps + {VAE_TRIAL_EPOCHS} "
             f"stacked validations + {retrain_steps} retrain steps)")
    seq_want = (0, 0, n_dec * TRIALS * (round_steps + VAE_TRIAL_EPOCHS))
    if seq_launches != seq_want:
        fail(f"vae trials: one-at-a-time launches (B1, B2, B3) = {seq_launches}, "
             f"expected {seq_want}")

    for text, what in (("mixed-architecture trials concurrently (padded, stacked)", "the padded path"),
                       ("Final full-data training with best params", "the final retrain")):
        if text not in cm_log:
            fail(f"vae trials: the CrossModalPred mixed round did not take {what}")
    cm_want = (0, 0, cm_model.train_result.epochs_run * (n // BATCH))  # one decoded layer
    if cm_launches != cm_want:
        fail(f"vae trials: the CrossModalPred mixed round launched (B1, B2, B3) {cm_launches}, "
             f"expected {cm_want}: B3 only in the retrain's steps (the padded trials take the "
             "masked MMD)")

    K_cv = CV_SUGGESTIONS * CV_FOLDS
    cv_text = f"Training {CV_SUGGESTIONS} suggestions x {CV_FOLDS} CV folds = {K_cv} trials"
    n_cv_tr = (n // CV_FOLDS) * (CV_FOLDS - 1)
    cv_steps = CV_EPOCHS * (n_cv_tr // BATCH)
    for name, cv_log, got, model_cv, per_step, per_val in (
            ("DirectPred", cv_dp_log, cv_dp_launches, cv_dp, (B1_PER_STEP, 0, 0),
             (0, B2_PER_FORWARD, 0)),
            ("supervised_vae", cv_vae_log, cv_vae_launches, cv_vae, (0, 0, n_dec),
             (0, 0, n_dec))):
        if cv_text not in cv_log or "Final full-data training" not in cv_log:
            fail(f"vae trials: the {name} CV run did not train {K_cv} trials at once and retrain")
        retrain = model_cv.train_result.epochs_run * (n // BATCH)
        evals = EVAL_FORWARDS if name == "DirectPred" else 0
        cv_want = tuple(s * (cv_steps + retrain) + v * (CV_EPOCHS + evals)
                        for s, v in zip(per_step, per_val))
        if got != cv_want:
            fail(f"vae trials: the {name} CV run launched (B1, B2, B3) {got}, expected "
                 f"{cv_want}: per stacked step {per_step}, per validation or evaluation "
                 f"forward {per_val}, {cv_steps} stacked steps, {CV_EPOCHS} stacked "
                 f"validations, {retrain} retrain steps, {evals} evaluation forwards")

    rate = {k: TRIALS / p["hpo_fit"] * 3600
            for k, p in (("batched", phases), ("sequential", seq_phases),
                         ("crossmodal_mixed", cm_phases))}
    print(f"vae trials: supervised_vae hpo_fit trials/h ({VAE_TRIAL_EPOCHS} epochs): batched "
          f"{rate['batched']:.0f}, one at a time {rate['sequential']:.0f} "
          f"({rate['batched'] / rate['sequential']:.2f}x); CrossModalPred mixed round "
          f"({CM_EPOCHS} epochs) {rate['crossmodal_mixed']:.0f}; launches (B1, B2, B3): batched "
          f"{launches}, one at a time {seq_launches}, CrossModalPred mixed {cm_launches}, CV "
          f"DirectPred {cv_dp_launches}, CV supervised_vae {cv_vae_launches}", flush=True)
    return ({"vae_batched": launches, "vae_sequential": seq_launches,
             "crossmodal_mixed": cm_launches, "cv_directpred": cv_dp_launches,
             "cv_supervised_vae": cv_vae_launches},
            {"trials_per_hour": rate, "stacked_step_ms": step_ms, "stacked_busy_pct": busy})


def train_vae(workdir: Path, model_class: str, epochs: int, layer_args=(), timed=True):
    """A VAE-MMD model class through the training CLI on the card, on the
    folder the DirectPred training phase wrote, with kernel B3 in every
    training step and validation and neither B1 nor B2 (the VAE's blocks are
    plain PyTorch), checked by launch counts; the loss falls; the saved model
    (and a CrossModalPred's decoded layers) served on the card and on the CPU
    agree. With ``timed``, also three steps card against CPU and the step
    time. Returns B3's launches in the CLI run."""
    import numpy as np
    from flexynesis_torch.__main__ import main as cli, parse_args, run_training
    from flexynesis_torch.data.inference_importer import DataImporterInference
    from flexynesis_torch.interpret.attribution import METHODS
    from flexynesis_torch.kernels.fused_linear import (
        fused_linear_bn_relu as b1,
        fused_linear_bn_relu_eval as b2,
    )
    from flexynesis_torch.kernels.mmd import gaussian_kernel_mean as b3, launches_per_call
    from flexynesis_torch.ops.losses import N_PRIOR_SAMPLES
    from flexynesis_torch.utils.csvio import read_matrix, read_table

    phase = f"{model_class} training"
    data = workdir / "fit_data"
    config = workdir / f"{model_class}_hpo.yaml"
    config.write_text(HPO_CONFIG % (model_class, LATENT, HIDDEN_FACTOR, SUP_HIDDEN, epochs, BATCH))
    out = workdir / f"{model_class}_out"
    b1.launches = b2.launches = b3.launches = 0
    t = time.perf_counter()
    model = run_training(*parse_args(
        train_args(data, config, out, DEVICE, model_class, layer_args, markers=True)))
    cli_s = time.perf_counter() - t
    launches = (b1.launches, b2.launches, b3.launches)

    decoded = model.output_layers if model_class == "CrossModalPred" else []
    expected_files = [f"fit.{x}.csv" for x in ("embeddings_train", "embeddings_test",
                                               "predicted_labels", "stats")] + [
        f"fit.{ln}_decoded.csv" for ln in decoded] + [
        f"fit.feature_importance.{m}.csv" for m in METHODS] + [
        "fit.final_model.safetensors", "fit.final_model_config.json", "fit.artifacts.json"]
    missing = [f for f in expected_files if not (out / f).exists()]
    if missing:
        fail(f"{phase}: the CLI did not write {missing}")
    res = model.train_result
    n = len(next(iter(model.ann.values())))
    n_val = int(np.ceil(n * VAL_SIZE))
    steps = res.epochs_run * ((n - n_val) // BATCH)

    def per_mmd(rows):  # B3 launches of one MMD term (prior-prior, z-z, prior-z)
        return launches_per_call(N_PRIOR_SAMPLES, rows)

    n_dec = len(model.decoded_layers)
    want = (0, 0, n_dec * (steps * per_mmd(BATCH) + res.epochs_run * per_mmd(n_val)))
    if launches != want:
        fail(f"{phase}: launches (B1, B2, B3) = {launches}, expected {want} ({n_dec} decoded "
             f"layers x ({steps} steps x {per_mmd(BATCH)} + {res.epochs_run} validations x "
             f"{per_mmd(n_val)}))")
    losses = res.history["train_loss"]
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        fail(f"{phase}: train loss did not fall: {losses}")
    print(f"{phase}: CLI on {DEVICE} {cli_s:.3f} s; {res.epochs_run} epochs x "
          f"{(n - n_val) // BATCH} steps; launches B1 0, B2 0, B3 {launches[2]} ({n_dec} decoded "
          f"layers x ({per_mmd(BATCH)} per step + {per_mmd(n_val)} per validation of {n_val} "
          "rows))", flush=True)
    print(f"{phase}: train loss by epoch " + json.dumps([round(v, 5) for v in losses])
          + "; val loss by epoch " + json.dumps([round(v, 5) for v in res.history["val_loss"]]),
          flush=True)
    print(f"{phase}: CLI phases (host clock, s): "
          + json.dumps({k: round(v, 4) for k, v in model.cli_phases.items()}), flush=True)
    for r in read_table(str(out / "fit.stats.csv"))[2]:
        print(f"{phase}: stats", ",".join(r), flush=True)
    check_importances(out, "fit", model, phase)
    for ln in decoded:
        _, cols, values = read_matrix(str(out / f"fit.{ln}_decoded.csv"))
        width = {"gex": GEX, "cnv": CNV}[ln]
        if values.shape != (FIT_TEST, width) or not ((values >= 0) & (values <= 1)).all():
            fail(f"{phase}: fit.{ln}_decoded.csv holds {values.shape} values, expected "
                 f"{(FIT_TEST, width)} in [0, 1]")
        print(f"{phase}: fit.{ln}_decoded.csv {values.shape[0]} x {values.shape[1]} values in "
              f"[{values.min():.4f}, {values.max():.4f}]", flush=True)

    served = {}
    for device in (DEVICE, "cpu"):
        served[device] = workdir / f"{model_class}_served_{device}"
        if cli(["--pretrained_model", str(out / "fit.final_model.safetensors"),
                "--artifacts", str(out / "fit.artifacts.json"),
                "--data_path_test", str(data / "test"), "--outdir", str(served[device]),
                "--prefix", "smoke", *marker_args(True), "--device", device]) != 0:
            fail(f"{phase}: serving the trained model on {device} returned nonzero")
    encoder = json.loads((out / "fit.artifacts.json").read_text())["label_encoders"]["subtype"]
    compare_outputs(served[DEVICE], served["cpu"], FIT_TEST, len(encoder["categories"][0]),
                    f"{phase}: the saved model served")
    compare_importances(served[DEVICE], served["cpu"], model, f"{phase}: the saved model served")
    for ln in decoded:
        a, b = (read_matrix(str(served[d] / f"smoke.{ln}_decoded.csv"))[2]
                for d in (DEVICE, "cpu"))
        if a.shape != b.shape or not np.allclose(a, b, **TOL):
            fail(f"{phase}: served {ln}_decoded differs between cuda and cpu")
        print(f"{phase}: served {ln}_decoded cuda vs cpu max abs diff "
              f"{float(np.abs(a - b).max()):.3e} (tol {TOL})", flush=True)

    if timed:
        cohort = DataImporterInference(str(data / "test"), str(out / "fit.artifacts.json"),
                                       verbose=False).import_data()
        check_card_matches_cpu(model, cohort)
        time_steps(model, cohort)
    return launches[2]


MARKER_TOL = dict(rtol=1e-4, atol=1e-6)  # f32 attributions, different summation orders


def read_importances(outdir: Path, prefix: str):
    """{method: (row keys, importances)} of a run's two importance tables."""
    import numpy as np
    from flexynesis_torch.interpret.attribution import METHODS
    from flexynesis_torch.utils.csvio import read_table

    tables = {}
    for method in METHODS:
        path = outdir / f"{prefix}.feature_importance.{method}.csv"
        if not path.exists():
            fail(f"{path} was not written")
        variables, columns, rows = read_table(str(path))
        if columns != ["target_class", "target_class_label", "layer", "name", "importance"]:
            fail(f"{path}: columns {columns}")
        tables[method] = ([(v, *r[:4]) for v, r in zip(variables, rows)],
                          np.array([float(r[4]) for r in rows]))
    return tables


def check_importances(outdir: Path, prefix: str, model, phase: str, capped: bool = False):
    """Each table holds the target's classes (N_CLASSES, one more where the
    attributed cohort has missing labels; with ``capped``, a subsample's, so
    possibly fewer) in order, each over every input feature, with finite
    importances >= 0 and a positive sum."""
    import numpy as np

    n_features = sum(model.input_dims)
    tables = read_importances(outdir, prefix)
    counts = range(1, N_CLASSES + 2) if capped else (N_CLASSES, N_CLASSES + 1)
    for method, (keys, imp) in tables.items():
        classes = [int(k[1]) for k in keys[::n_features]]
        if (len(keys) != len(classes) * n_features or classes != list(range(len(classes)))
                or len(classes) not in counts):
            fail(f"{phase}: {method} table of {len(keys)} rows, classes {classes}, "
                 f"expected {N_CLASSES} (+1) x {n_features}")
        if not (np.isfinite(imp).all() and (imp >= 0).all() and imp.sum() > 0):
            fail(f"{phase}: {method} importances not finite, >= 0 and positive in sum")
        print(f"{phase}: {prefix}.feature_importance.{method}.csv {len(classes)} classes x "
              f"{n_features} features, importance in [{imp.min():.3e}, {imp.max():.3e}], "
              f"sum {imp.sum():.4f}", flush=True)
    return tables


def compare_importances(out_card: Path, out_cpu: Path, model, phase: str,
                        capped: bool = False) -> None:
    """The two runs' tables: the same rows, importances within MARKER_TOL."""
    import numpy as np
    from flexynesis_torch.interpret.attribution import METHODS

    card = check_importances(out_card, "smoke", model, f"{phase} on {DEVICE}", capped)
    cpu = check_importances(out_cpu, "smoke", model, f"{phase} on cpu", capped)
    for method in METHODS:
        (keys, a), (keys_cpu, b) = card[method], cpu[method]
        if keys != keys_cpu:
            fail(f"{phase}: the {method} tables of cuda and cpu hold different rows")
        err = float(np.abs(a - b).max())
        if not np.allclose(a, b, **MARKER_TOL):
            fail(f"{phase}: {method} importances differ between cuda and cpu: max abs diff "
                 f"{err:.3e}, max rel {float((np.abs(a - b) / np.abs(b).clip(1e-30)).max()):.3e}")
        print(f"{phase}: {method} importances cuda vs cpu max abs diff {err:.3e} "
              f"(tol {MARKER_TOL})", flush=True)


def read_raw_folder(data: Path):
    """Phase 5's raw matrices through the native reader and through the Python
    reader in this process: seconds of each, and the matrices held against each
    other. The Python reader rounds a cell twice (float64, then float32), so a
    cell may differ only where that lands on the other side of a float32
    midpoint: each differing cell is printed with its text and must equal the
    correctly rounded float32 of that text, as the native reader's should."""
    from fractions import Fraction

    import numpy as np
    from flexynesis_torch.data.fastcsv import read_matrix_csv
    from flexynesis_torch.utils.csvio import read_matrix

    def exact_f32(text: str) -> np.float32:
        """The float32 nearest to the decimal ``text`` (ties to even)."""
        q = Fraction(text)
        near = np.float32(float(q))  # within one float32 ulp of q
        best = min((near, np.nextafter(near, np.float32(np.inf)),
                    np.nextafter(near, np.float32(-np.inf))),
                   key=lambda f: (abs(Fraction(float(f)) - q),
                                  int(np.array(f).view(np.uint32)) & 1))
        return np.float32(best)

    seconds = {"native": 0.0, "python": 0.0}
    for split in ("train", "test"):
        for layer in ("gex", "cnv"):
            path = data / split / f"{layer}.csv"
            t = time.perf_counter()
            native = read_matrix_csv(str(path))
            t_native = time.perf_counter() - t
            t = time.perf_counter()
            names, columns, mat = read_matrix(str(path))
            py = mat.astype(np.float32)
            t_python = time.perf_counter() - t
            seconds["native"] += t_native
            seconds["python"] += t_python
            if (native[0], native[1]) != (names, columns) or native[2].shape != py.shape:
                fail(f"readers: {path}: the readers give different names or shapes")
            a, b = native[2], py
            nan = np.isnan(a)
            if not np.array_equal(nan, np.isnan(b)):
                fail(f"readers: {path}: missing cells differ between the readers")
            diff = np.argwhere(~nan & (a.view(np.uint32) != b.view(np.uint32)))
            if len(diff):
                with open(path) as fh:
                    lines = fh.read().splitlines()
                for i, j in diff:
                    text = lines[i + 1].split(",")[j + 1]
                    print(f"readers: {path.name} {names[i]},{columns[j]} '{text}': native "
                          f"{a[i, j]!r}, python {b[i, j]!r}", flush=True)
                    if a[i, j] != exact_f32(text):
                        fail(f"readers: the native reader misrounds '{text}'")
            print(f"readers: {split}/{layer}.csv {a.shape[0]} x {a.shape[1]}: native "
                  f"{t_native:.3f} s, python {t_python:.3f} s, "
                  f"{'equal' if not len(diff) else f'{len(diff)} cells differ'}", flush=True)
    print(f"readers: phase 5's raw folder: native {seconds['native']:.3f} s, python "
          f"{seconds['python']:.3f} s ({seconds['python'] / seconds['native']:.1f}x)",
          flush=True)
    return seconds


def marker_seconds(model, cohort, label: str) -> dict:
    """Host-clock seconds of ``compute_feature_importance`` of each method
    over ``cohort`` on the card (25 steps or draws), after one warm-up; then
    a profiled run of IntegratedGradients with the card's busy share."""
    import torch
    from flexynesis_torch.interpret.attribution import METHODS
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    var = model.target_variables[0]
    seconds = {}
    for method in METHODS:
        model.compute_feature_importance(cohort, var, method=method, steps_or_samples=25)
        torch.cuda.synchronize()
        t = time.perf_counter()
        model.compute_feature_importance(cohort, var, method=method, steps_or_samples=25)
        torch.cuda.synchronize()
        seconds[method] = time.perf_counter() - t
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        model.compute_feature_importance(cohort, var, steps_or_samples=25)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in device)
    busy = (f"device busy {busy_us:.0f} us of {wall_us:.0f} us "
            f"({100 * busy_us / wall_us:.1f}%), {sum(e.count for e in device)} device "
            "operations; top: " + "; ".join(
                f"{e.key[:40]} {e.self_device_time_total:.0f} us"
                for e in sorted(device, key=lambda e: -e.self_device_time_total)[:4])
            if busy_us > 0 else "the profiler saw no device time (not measured)")
    print(f"markers: {label} ({len(cohort)} samples): IntegratedGradients "
          f"{seconds['IntegratedGradients']:.3f} s, GradientShap {seconds['GradientShap']:.3f} s "
          f"on the card; profiled IntegratedGradients: {busy}", flush=True)
    return seconds


def refuse_fused(workdir: Path) -> None:
    """A fused DirectPred with marker finding on exits nonzero with the port's
    refusal, in training mode (phase 5's config) before any work, and in
    inference mode (phase 4's model)."""
    import os

    from flexynesis_torch.interpret.attribution import FUSED_REFUSAL

    data = workdir / "fit_data"
    runs = {
        "training": train_args(data, workdir / "fit_hpo.yaml", workdir / "refused_fit",
                               DEVICE, markers=True),
        "inference": ["--pretrained_model", str(workdir / "smoke.final_model.safetensors"),
                      "--artifacts", str(workdir / "smoke.artifacts.json"),
                      "--data_path_test", str(workdir / "data" / "test"),
                      "--outdir", str(workdir / "refused_served"), "--device", DEVICE],
    }
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO), os.environ.get("PYTHONPATH", "")]))
    for mode, argv in runs.items():
        t = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "flexynesis_torch", *argv], cwd=REPO,
                              env=env, capture_output=True, text=True, timeout=300)
        said = f"NotImplementedError: {FUSED_REFUSAL}" in proc.stderr
        if proc.returncode == 0 or not said:
            fail(f"markers: the fused DirectPred's {mode} run returned {proc.returncode} "
                 f"without the refusal:\n{proc.stderr[-2000:]}")
        print(f"markers: fused DirectPred, {mode} with marker finding: exit "
              f"{proc.returncode} in {time.perf_counter() - t:.1f} s with the refusal",
              flush=True)


def markers(workdir: Path) -> dict:
    """The marker-finding phase on phase 5's folder: both readers on its raw
    matrices; a default DirectPred (fused_kernels off, as in the JAX package)
    through the training CLI on the card with both methods, its tables
    checked, then served with marker finding on the card and on the CPU (the
    tables agree); the seconds of each method over the 500-sample test
    cohort and over the 2000 training samples as a cohort (four batches, the
    last zero-padded); the fused refusal. No port kernel lies on this path:
    B1, B2 and B3 must launch no time. Returns the summary numbers."""
    from flexynesis_torch.__main__ import main as cli, parse_args, run_training
    from flexynesis_torch.data.inference_importer import DataImporterInference
    from flexynesis_torch.kernels.fused_linear import (
        fused_linear_bn_relu as b1,
        fused_linear_bn_relu_eval as b2,
    )
    from flexynesis_torch.kernels.mmd import gaussian_kernel_mean as b3

    data = workdir / "fit_data"
    reader_s = read_raw_folder(data)

    config = workdir / "markers_hpo.yaml"
    config.write_text((HPO_CONFIG % ("DirectPred", LATENT, HIDDEN_FACTOR, SUP_HIDDEN,
                                     FIT_EPOCHS, BATCH)).replace("[true]", "[false]"))
    out = workdir / "markers_out"
    b1.launches = b2.launches = b3.launches = 0
    t = time.perf_counter()
    model = run_training(*parse_args(train_args(data, config, out, DEVICE, markers=True)))
    cli_s = time.perf_counter() - t
    launches = (b1.launches, b2.launches, b3.launches)
    if launches != (0, 0, 0):
        fail(f"markers: the unfused DirectPred run launched (B1, B2, B3) {launches} times")
    if model.input_dims != [GEX, CNV] or model.config.get("fused_kernels"):
        fail(f"markers: unexpected model: widths {model.input_dims}, config {model.config}")
    print(f"markers: default DirectPred (fused_kernels off) through the training CLI on "
          f"{DEVICE} {cli_s:.3f} s; launches B1, B2, B3 {launches}; CLI phases (host clock, s): "
          + json.dumps({k: round(v, 4) for k, v in model.cli_phases.items()}), flush=True)
    check_importances(out, "fit", model, "markers: training CLI")

    served = {}
    for device in (DEVICE, "cpu"):
        served[device] = workdir / f"markers_served_{device}"
        t = time.perf_counter()
        if cli(["--pretrained_model", str(out / "fit.final_model.safetensors"),
                "--artifacts", str(out / "fit.artifacts.json"),
                "--data_path_test", str(data / "test"), "--outdir", str(served[device]),
                "--prefix", "smoke", *marker_args(True), "--device", device]) != 0:
            fail(f"markers: serving with marker finding on {device} returned nonzero")
        print(f"markers: inference CLI with marker finding on {device} "
              f"{time.perf_counter() - t:.3f} s", flush=True)
    compare_importances(served[DEVICE], served["cpu"], model, "markers: served")

    art = str(out / "fit.artifacts.json")
    cohort_test = DataImporterInference(str(data / "test"), art, verbose=False).import_data()
    cohort_train = DataImporterInference(str(data / "train"), art, verbose=False).import_data()
    seconds = {"test": marker_seconds(model, cohort_test, "the test cohort"),
               "train": marker_seconds(model, cohort_train, "the training samples as a cohort")}
    refuse_fused(workdir)
    return {"reader_seconds": reader_s, "marker_finding_cli_s": model.cli_phases["marker_finding"],
            "import_cli_s": model.cli_phases["import_and_feature_selection"],
            "marker_seconds": seconds, "launches": launches}


# ------------------------------------------------ phase 10: the model zoo

# MultiTripletNetwork at the headline width on phase 5's folder: the same
# HPO_CONFIG, with fused_kernels true (the triplet model ignores it, as in
# the JAX package, so no kernel of the port lies on its path)
TRIPLET_TRIAL_EPOCHS = 10  # the batched and one-at-a-time triplet rounds
# the GNN: gex and cnv rows over the same gene names (the cnv rows are the
# first RAW_CNV of gex's RAW_GEX genes), a ring plus two random edges per gene
# over all RAW_GEX genes; GC convs, the CLI's default
GNN_EMBED, GNN_CONVS = 16, 2
GNN_TRIAL_EPOCHS = 5  # the batched and one-at-a-time GNN rounds, cut alike
GNN_MIXED_EPOCHS = 3
STRING_NODES, STRING_SAMPLES = 10000, 320  # the sparse operator's scale
GNN_CONFIG = """GNN:
  - {type: Categorical, categories: [%d], name: latent_dim}
  - {type: Categorical, categories: [%d], name: node_embedding_dim}
  - {type: Categorical, categories: [%d], name: num_convs}
  - %s
  - {type: Categorical, categories: [%d], name: supervisor_hidden_dim}
  - {type: Categorical, categories: [%d], name: epochs}
  - {type: Categorical, categories: [%d], name: batch_size}
"""
LR_FIXED = "{type: Categorical, categories: [0.001], name: lr}"
LR_FREE = "{type: Real, low: 0.0001, high: 0.01, prior: log-uniform, name: lr}"
# the default GNN space (flexynesis_torch/config.py) with epochs and batch
# size fixed: the suggestions bucket by num_convs (activation is relu only)
GNN_MIXED_CONFIG = """GNN:
  - {type: Integer, low: 16, high: 128, quantize: 16, name: latent_dim}
  - {type: Integer, low: 4, high: 32, quantize: 4, name: node_embedding_dim}
  - {type: Integer, low: 1, high: 4, name: num_convs}
  - {type: Real, low: 0.0001, high: 0.01, prior: log-uniform, name: lr}
  - {type: Integer, low: 8, high: 32, quantize: 8, name: supervisor_hidden_dim}
  - {type: Categorical, categories: [%d], name: epochs}
  - {type: Categorical, categories: [%d], name: batch_size}
  - {type: Categorical, categories: [relu], name: activation}
"""
ZOO_LAUNCHES = (0, 0, 0)  # B1, B2 and B3 on every triplet and GNN path
# the genes of the repo's STRING fixtures (tests/fixtures/string), which name
# the first rows of both layers of the STRING CLI run's small folder
STRING_GENES = ("TP53", "BRCA1", "EGFR", "MYC", "KRAS", "PTEN", "RB1", "ATM")


def zoo_launches(what: str, got) -> None:
    if tuple(got) != ZOO_LAUNCHES:
        fail(f"{what}: launched (B1, B2, B3) {tuple(got)} times; no kernel of the port lies "
             "on this path")


def method_seconds(model, cohort, label: str) -> dict:
    """Host-clock seconds of one ``compute_feature_importance`` per method
    over ``cohort`` on the card (25 steps or draws, after the CLI's run)."""
    import torch
    from flexynesis_torch.interpret.attribution import METHODS

    var = model.target_variables[0]
    seconds = {}
    for method in METHODS:
        torch.cuda.synchronize()
        t = time.perf_counter()
        model.compute_feature_importance(cohort, var, method=method, steps_or_samples=25)
        torch.cuda.synchronize()
        seconds[method] = time.perf_counter() - t
    print(f"{label}: marker finding over {len(cohort)} samples on the card: "
          + ", ".join(f"{m} {s:.3f} s" for m, s in seconds.items()), flush=True)
    return seconds


def zoo_cli_run(data: Path, config: Path, out: Path, model_class: str, extra=()):
    """One training CLI run on the card (marker finding with both methods);
    returns the model, the (B1, B2, B3) launches and the log."""
    from flexynesis_torch.__main__ import parse_args, run_training
    from flexynesis_torch.kernels.fused_linear import (
        fused_linear_bn_relu as b1,
        fused_linear_bn_relu_eval as b2,
    )
    from flexynesis_torch.kernels.mmd import gaussian_kernel_mean as b3

    b1.launches = b2.launches = b3.launches = 0
    with Tee() as log:
        model = run_training(*parse_args(train_args(data, config, out, DEVICE, model_class,
                                                    extra, markers=True)))
    launches = (b1.launches, b2.launches, b3.launches)
    missing = [f for f in ("fit.stats.csv", "fit.predicted_labels.csv", "fit.embeddings_test.csv",
                           "fit.embeddings_train.csv", "fit.final_model.safetensors",
                           "fit.final_model_config.json", "fit.artifacts.json")
               if not (out / f).exists()]
    if missing:
        fail(f"{model_class}: the training CLI did not write {missing}")
    losses = model.train_result.history["train_loss"]
    if not (all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]):
        fail(f"{model_class}: train loss did not fall: {losses}")
    return model, launches, log.text


def serve_both(workdir: Path, out: Path, test: Path, name: str, model, extra=()):
    """The saved model through the inference CLI on the card and on the CPU
    with marker finding (both methods): the outputs and the importance tables
    agree. Returns the host-clock seconds of each run."""
    from flexynesis_torch.__main__ import main as cli

    seconds, served = {}, {}
    for device in (DEVICE, "cpu"):
        served[device] = workdir / f"{name}_served_{device}"
        t = time.perf_counter()
        if cli(["--pretrained_model", str(out / "fit.final_model.safetensors"),
                "--artifacts", str(out / "fit.artifacts.json"),
                "--data_path_test", str(test), "--outdir", str(served[device]),
                "--prefix", "smoke", *marker_args(True), *extra, "--device", device]) != 0:
            fail(f"{name}: serving on {device} returned nonzero")
        seconds[device] = time.perf_counter() - t
    encoder = json.loads((out / "fit.artifacts.json").read_text())["label_encoders"]["subtype"]
    n_test = len((test / "clin.csv").read_text().splitlines()) - 1
    compare_outputs(served[DEVICE], served["cpu"], n_test, len(encoder["categories"][0]),
                    f"{name}: the saved model served")
    compare_importances(served[DEVICE], served["cpu"], model, f"{name}: served",
                        "--marker_sample_cap" in extra)
    print(f"{name}: inference CLI with marker finding {extra or ''}: {DEVICE} "
          f"{seconds[DEVICE]:.3f} s, cpu {seconds['cpu']:.3f} s", flush=True)
    return seconds


def round_rates(name: str, runs: dict) -> dict:
    """trials/h of each CLI run's hpo_fit (CV runs: suggestions/h)."""
    rate = {k: n / phases["hpo_fit"] * 3600 for k, (phases, n) in runs.items()}
    print(f"{name}: hpo_fit trials/h: " + ", ".join(f"{k} {v:.0f}" for k, v in rate.items())
          + (f"; batched / one at a time {rate['batched'] / rate['sequential']:.2f}x"
             if "batched" in rate and "sequential" in rate else ""), flush=True)
    return rate


def check_round_logs(name: str, logs: dict, K_cv=None) -> None:
    """The log lines that show each CLI round took its path."""
    wants = {
        "batched": [f"HPO trial fan-out: {TRIALS} suggestions per GP round",
                    f"Training {TRIALS} same-architecture trials concurrently (stacked)"],
        "mixed": ["mixed-architecture trials concurrently (padded, stacked)",
                  "Final full-data training with best params"],
        "cv": [f"Training {CV_SUGGESTIONS} suggestions x {CV_FOLDS} CV folds = "
               f"{CV_SUGGESTIONS * CV_FOLDS} trials concurrently (stacked)",
               "Final full-data training with best params"],
    }
    for kind, log in logs.items():
        for text in wants.get(kind, []):
            if text not in log:
                fail(f"{name}: the {kind} round's log lacks '{text}'")


def triplet(workdir: Path, importer_cache: ImportOnce, cohort) -> tuple:
    """MultiTripletNetwork on phase 5's folder at the headline width: one
    trial of FIT_EPOCHS epochs through the training CLI with marker finding,
    its saved model served with marker finding on the card and on the CPU,
    three steps card against CPU, the step time, three stacked steps against
    Trainer steps and the CPU, the stacked step's time; then CLI rounds:
    TRIALS suggestions batched (lr free) and one at a time, a padded mixed
    round of the default space and a --use_cv round. B1, B2 and B3 launch no
    time. Returns each run's launches and the summary numbers."""
    import numpy as np

    data = workdir / "fit_data"
    config = workdir / "triplet_hpo.yaml"
    config.write_text(HPO_CONFIG % ("MultiTripletNetwork", LATENT, HIDDEN_FACTOR, SUP_HIDDEN,
                                    FIT_EPOCHS, BATCH))
    out = workdir / "triplet_out"
    t = time.perf_counter()
    with importer_cache:
        model, launches, _ = zoo_cli_run(data, config, out, "MultiTripletNetwork")
    cli_s = time.perf_counter() - t
    zoo_launches("triplet training", launches)
    widths = (model.input_dims, [model.module.encoder_gex.layer_1.out_features,
                                 model.module.encoder_cnv.layer_1.out_features])
    if widths != ([GEX, CNV], [int(GEX * HIDDEN_FACTOR), int(CNV * HIDDEN_FACTOR)]):
        fail(f"triplet: widths {widths}")
    res = model.train_result
    print(f"triplet: training CLI on {DEVICE} {cli_s:.3f} s ({res.epochs_run} epochs over "
          f"{model.n_train_samples()} anchors, fused_kernels true and ignored); launches "
          f"(B1, B2, B3) {launches}; train loss by epoch "
          + json.dumps([round(v, 5) for v in res.history["train_loss"]])
          + "; CLI phases (host clock, s): "
          + json.dumps({k: round(v, 4) for k, v in model.cli_phases.items()}), flush=True)
    check_importances(out, "fit", model, "triplet: training CLI")
    serve_s = serve_both(workdir, out, data / "test", "triplet", model)
    seconds = method_seconds(model, cohort, "triplet")

    check_card_matches_cpu(model, cohort, "MultiTripletNetwork")
    # the sampler's tables index the dataset a triplet model was built on
    on_cohort = type(model)(model.config, cohort, target_variables=model.target_variables,
                            device=DEVICE)
    on_cohort.init_params(seed=0)
    step_ms = time_steps(on_cohort, cohort) * 1e3
    h_config = {"latent_dim": LATENT, "hidden_dim_factor": HIDDEN_FACTOR,
                "supervisor_hidden_dim": SUP_HIDDEN, "lr": 1e-3, "epochs": FIT_EPOCHS,
                "batch_size": BATCH}
    # noise: an entry may part within 2 x steps x lr in an MLP unit whose
    # pre-activations (BatchNorm's output, before ReLU) changed sign between
    # the runs, or as one of max(1, 1e-4 of its leaf) others; the first two
    # chip runs parted 1 entry (1.2e-4) and then 421 entries of one gex
    # encoder unit (up to 4.3e-3) of trial 3 (lr 3e-3): the triplet loss
    # drives all 3 x 64 rows of a BatchNorm, so more rows sit near ReLU's kink
    check_stacked_steps(h_config, cohort, "MultiTripletNetwork", noise=True, watch_mlp=True)
    stacked_ms, busy = time_stacked_steps(h_config, cohort, TRIALS, "MultiTripletNetwork")

    same = TRIAL_CONFIG.replace("DirectPred:", "MultiTripletNetwork:") % (
        LATENT, HIDDEN_FACTOR, SUP_HIDDEN, TRIPLET_TRIAL_EPOCHS, BATCH)
    runs, logs, launches_by = {}, {}, {"triplet_training": launches}
    mixed_cfg = MIXED_CONFIG.replace("DirectPred:", "MultiTripletNetwork:")
    cv_cfg = TRIAL_CONFIG.replace("DirectPred:", "MultiTripletNetwork:") % (
        LATENT, HIDDEN_FACTOR, SUP_HIDDEN, CV_EPOCHS, BATCH)
    with importer_cache:
        for kind, text, extra, n_iter in (
                ("batched", same, (), TRIALS),
                ("sequential", same, ("--hpo_batch", "1"), TRIALS),
                ("mixed", mixed_cfg % (MIXED_EPOCHS, BATCH), (), TRIALS),
                ("cv", cv_cfg, ("--use_cv",), CV_SUGGESTIONS)):
            _, phases, got, logs[kind], _ = hpo_run(workdir, f"triplet_{kind}", text, extra,
                                                    "MultiTripletNetwork", n_iter)
            zoo_launches(f"triplet {kind} round", got)
            runs[kind] = (phases, n_iter)
            launches_by[f"triplet_{kind}"] = got
    check_round_logs("triplet", logs)
    rate = round_rates("triplet", runs)
    return launches_by, {"trials_per_hour": rate, "step_ms": step_ms,
                         "stacked_step_ms": stacked_ms, "stacked_busy_pct": busy,
                         "cli_phases": model.cli_phases, "marker_seconds": seconds,
                         "serve_seconds": serve_s}


def dense_vs_sparse(cohort, conv: str, label: str, cpu_too: bool = False) -> dict:
    """One GNN of ``conv`` with the dense and with the sparse operator, the
    same weights (dropout 0): the eval outputs, one training loss and its
    gradients agree (rtol/atol 1e-4; on the card, and with ``cpu_too`` also
    the CPU's sparse path); the median of 10 synchronised training steps of each and each
    one's peak allocated memory."""
    import torch
    from flexynesis_torch.models.gnn import GNN
    from flexynesis_torch.train.trainer import Trainer, gather

    cfg = {"latent_dim": LATENT, "node_embedding_dim": GNN_EMBED, "num_convs": GNN_CONVS,
           "supervisor_hidden_dim": SUP_HIDDEN, "lr": 1e-3}
    n = len(cohort)
    rows = torch.randperm(n, generator=torch.Generator().manual_seed(2))[:BATCH]
    results, times, peaks = {}, {}, {}
    forms = [("dense", DEVICE, False), ("sparse", DEVICE, True)]
    if cpu_too:
        forms.append(("sparse_cpu", "cpu", True))
    for form, device, sparse in forms:
        on_card = form != "sparse_cpu"
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        m = _no_dropout(GNN(dict(cfg, gnn_sparse=sparse), cohort, ["subtype"], device=device,
                            gnn_conv_type=conv))
        m.init_params(seed=4)
        with torch.no_grad():
            out = m._forward_eval(m.make_eval_x(cohort))["outputs"]["subtype"].cpu()
        data = m.make_batch(cohort)
        batch = gather(data, rows.to(device))
        total, _ = m.loss_fn(batch, torch.Generator().manual_seed(1), True)
        names, params = zip(*m.module.named_parameters())
        grads = torch.autograd.grad(total, params, allow_unused=True)
        results[form] = (out, float(total), {n: g.cpu() for n, g in zip(names, grads)
                                             if g is not None})
        if on_card:
            trainer = Trainer(m.module, m.loss_fn, lr=1e-3)
            gen = torch.Generator(device=DEVICE).manual_seed(0)
            trainer.train_step(batch, gen)
            steps = []
            for _ in range(10):
                torch.cuda.synchronize()
                t = time.perf_counter()
                trainer.train_step(batch, gen)
                torch.cuda.synchronize()
                steps.append(time.perf_counter() - t)
            times[form] = statistics.median(steps) * 1e3
            peaks[form] = torch.cuda.max_memory_allocated() / 2 ** 30
        del m, data, batch
    ref = results["dense"]
    for form, (out, loss, grads) in results.items():
        err = float((out - ref[0]).abs().max())
        diffs = {n: float((g - ref[2][n]).abs().max()) for n, g in grads.items()}
        worst = max(diffs, key=diffs.get)
        g_err = diffs[worst]
        g_ok = all(torch.allclose(g, ref[2][n], **TOL) for n, g in grads.items())
        if not (torch.allclose(out, ref[0], **TOL) and math.isclose(loss, ref[1], rel_tol=1e-4)
                and g_ok):
            fail(f"{label}: {form} against dense: outputs {err:.3e}, loss {loss} vs {ref[1]}, "
                 f"gradients {g_err:.3e} in {worst}")
        if form != "dense":
            print(f"{label}: {conv} {form} against dense on {DEVICE}: eval outputs max abs diff "
                  f"{err:.3e}, loss {loss:.6f} vs {ref[1]:.6f}, gradients max abs diff "
                  f"{g_err:.3e} in {worst} (tol {TOL})", flush=True)
    print(f"{label}: {conv} training step (batch {BATCH}) x10, median: dense "
          f"{times['dense']:.3f} ms, sparse {times['sparse']:.3f} ms; peak allocated dense "
          f"{peaks['dense']:.3f} GiB, sparse {peaks['sparse']:.3f} GiB", flush=True)
    return {"dense_ms": times["dense"], "sparse_ms": times["sparse"],
            "dense_peak_gib": peaks["dense"], "sparse_peak_gib": peaks["sparse"]}


def nw_cohort(model, test: Path, artifacts: Path):
    """The test folder as inference imports it for ``model``, over its node set."""
    import numpy as np
    from flexynesis_torch.data.dataset import MultiOmicDatasetNW
    from flexynesis_torch.data.inference_importer import DataImporterInference

    base = DataImporterInference(str(test), str(artifacts), verbose=False).import_data()
    nodes = list(model.nw_dataset.node_names)
    src, dst = np.asarray(model.nw_dataset.edge_index)
    return MultiOmicDatasetNW(base, {"protein1": [nodes[i] for i in src],
                                     "protein2": [nodes[i] for i in dst]}, node_names=nodes)


PROBE_CALLS = 6  # the gradients, and the products alone, that weight_grad_probe takes


def weight_grad_probe(ds, cfg) -> None:
    """Where the card's gradient parts from the CPU's at STRING scale: one
    GNN's first-step gradient taken PROBE_CALLS times on the card from the
    same weights and batch. For each call: its largest difference from the
    CPU's gradient and the parameter; conv_1.lin_nbr's weight gradient
    against the float64 product of the operands that call saved (the
    (n, 16) X and dY), as a share of sqrt(n) eps_f32 sum|terms|; how far
    those operands part from the first call's; the GEMM kernels it ran.
    Then the product dY^T X alone on the first call's operands, as often,
    with its kernels. Prints; checks nothing."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from flexynesis_torch.models.gnn import GNN
    from flexynesis_torch.train.trainer import gather

    rows = torch.randperm(len(ds), generator=torch.Generator().manual_seed(5))[:BATCH]
    models = {}
    for device in ("cpu", DEVICE):
        m = _no_dropout(GNN(cfg, ds, ["subtype"], device=device))
        m.init_params(seed=3)
        models[device] = (m, gather(m.make_batch(ds), rows.to(device)))

    def gradient(device):
        m, batch = models[device]
        total, _ = m.loss_fn(batch, torch.Generator().manual_seed(11), True)
        grads = torch.autograd.grad(total, list(m.module.parameters()), allow_unused=True)
        return [None if g is None else g.cpu() for g in grads]

    def kernels(prof, word: str) -> list:
        return sorted({e.key[:72] for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA and word in e.key.lower()})

    def against(g, x, dy) -> str:
        x, dy = x.double().cpu(), dy.double().cpu()
        depth = math.sqrt(x.shape[0]) * EPS_F32 * (dy.abs().T @ x.abs())
        err = (g.double().cpu() - dy.T @ x).abs()
        return f"{float(err.max()):.3e} ({float((err / depth).max()):.4f} of the bound term)"

    names = [n for n, _ in models["cpu"][0].module.named_parameters()]
    nbr = models[DEVICE][0].module.encoder.conv_1.lin_nbr.weight
    ref = gradient("cpu")
    saved = None
    for i in range(PROBE_CALLS):
        with ReductionScale() as scale, profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            g = gradient(DEVICE)
            torch.cuda.synchronize()
        diffs = [0.0 if a is None else float((a - b).abs().max()) for a, b in zip(g, ref)]
        worst = max(range(len(diffs)), key=diffs.__getitem__)
        call = next(c for c in scale.calls if c["params"][0] is nbr)
        saved = saved or (call["x"], call["dy"])
        print(f"string scale probe: gradient call {i}: card vs cpu max abs diff "
              f"{diffs[worst]:.3e} in {names[worst]}; conv_1.lin_nbr weight gradient vs the "
              f"float64 product of its {call['x'].shape[0]} saved rows "
              f"{against(g[names.index('encoder.conv_1.lin_nbr.weight')], call['x'], call['dy'])}"
              f"; its X and dY part from call 0's by "
              f"{float((call['x'] - saved[0]).abs().max()):.3e} and "
              f"{float((call['dy'] - saved[1]).abs().max()):.3e}; GEMM kernels "
              f"{kernels(prof, 'gemm')}",
              flush=True)
    x, dy = saved
    for i in range(PROBE_CALLS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            product = dy.T @ x
            torch.cuda.synchronize()
        print(f"string scale probe: dY^T X alone, call {i}: vs float64 {against(product, x, dy)}"
              f"; kernels {kernels(prof, '')}", flush=True)


def string_cli(workdir: Path) -> dict:
    """``--model_class GNN`` with its graph from STRING (no ``--user_graph``)
    over a warm cache, as the card's machine has no network: the repo's
    STRING fixtures copied under the names the reader caches them by into a
    FLEXYNESIS_CACHE in the work folder; a small folder whose first rows in
    both layers are the fixtures' genes. One trial through the training CLI
    on the card with marker finding (a node set of those genes), then the
    saved model served on the card and on the CPU (``serve_both``). B1, B2
    and B3 launch no time. Returns the host-clock seconds of each run."""
    import os
    import shutil

    from flexynesis_torch.utils.synthetic import write_synthetic_folder

    data, cache, out = workdir / "string_data", workdir / "string_cache", workdir / "string_out"
    write_synthetic_folder(str(data), n_train=40, n_test=16, n_features={"gex": 12, "cnv": 10},
                           n_classes=N_CLASSES, seed=3, gene_names=True)
    for split in ("train", "test"):
        for layer in ("gex", "cnv"):
            path = data / split / f"{layer}.csv"
            lines = path.read_text().splitlines()
            for i, gene in enumerate(STRING_GENES):
                lines[1 + i] = gene + lines[1 + i][len(f"g{i}"):]
            path.write_text("\n".join(lines) + "\n")
    cache.mkdir(exist_ok=True)
    fixtures = Path(__file__).resolve().parent / "tests" / "fixtures" / "string"
    for kind in ("links", "aliases"):
        shutil.copy(fixtures / f"9606.protein.{kind}.v12.0.txt.gz", cache / f"9606.{kind}.txt.gz")
    config = workdir / "string_hpo.yaml"
    config.write_text(GNN_CONFIG % (LATENT, GNN_EMBED, GNN_CONVS, LR_FIXED, SUP_HIDDEN, 3, 16))
    previous = os.environ.get("FLEXYNESIS_CACHE")
    os.environ["FLEXYNESIS_CACHE"] = str(cache)
    try:
        t = time.perf_counter()
        model, launches, log = zoo_cli_run(data, config, out, "GNN")
        cli_s = time.perf_counter() - t
    finally:
        if previous is None:
            os.environ.pop("FLEXYNESIS_CACHE")
        else:
            os.environ["FLEXYNESIS_CACHE"] = previous
    zoo_launches("gnn STRING training", launches)
    nodes = list(model.nw_dataset.node_names)
    if "Downloading" in log or not (5 <= len(nodes) and set(nodes) <= set(STRING_GENES)):
        fail(f"gnn STRING: node set {nodes} (expected at least 5 of {STRING_GENES}, from the "
             "cache with no download)")
    print(f"gnn STRING: training CLI on {DEVICE} over the warm cache {cli_s:.3f} s: "
          f"{len(nodes)} nodes {nodes}, {model.nw_dataset.edge_index.shape[1]} edges; launches "
          f"(B1, B2, B3) {launches}", flush=True)
    check_importances(out, "fit", model, "gnn STRING: training CLI")
    serve_s = serve_both(workdir, out, data / "test", "gnn STRING", model)
    return {"cli_s": cli_s, "serve_seconds": serve_s}


def string_scale() -> dict:
    """STRING scale at the model level: STRING_NODES genes (gex over all of
    them, cnv over the first half), a ring plus two random edges per gene;
    ``gnn_sparse: "auto"`` must take the edge list; three training steps and
    the eval forward on the card against the CPU; the step time; dense
    against sparse at the same node count on the card."""
    import numpy as np
    import torch
    from flexynesis_torch.data.dataset import MultiOmicDataset, MultiOmicDatasetNW
    from flexynesis_torch.models.gnn import GNN

    rng = np.random.default_rng(7)
    n, N = STRING_SAMPLES, STRING_NODES
    cls = rng.integers(0, N_CLASSES, n)
    gex = (rng.normal(size=(n, N)) + 0.5 * cls[:, None]).astype(np.float32)
    cnv = rng.normal(size=(n, N // 2)).astype(np.float32)
    base = MultiOmicDataset(
        dat={"gex": gex, "cnv": cnv}, ann={"subtype": cls.astype(np.float32)},
        variable_types={"subtype": "categorical"},
        features={"gex": [f"g{i}" for i in range(N)], "cnv": [f"g{i}" for i in range(N // 2)]},
        samples=[f"S{i}" for i in range(n)],
        label_mappings={"subtype": {i: f"grp{i}" for i in range(N_CLASSES)}})
    a = np.concatenate([np.arange(N), np.repeat(np.arange(N), 2)])
    b = np.concatenate([(np.arange(N) + 1) % N, rng.integers(0, N, 2 * N)])
    graph = {"protein1": [f"g{i}" for i in a], "protein2": [f"g{i}" for i in b]}
    t = time.perf_counter()
    ds = MultiOmicDatasetNW(base, graph)
    build_s = time.perf_counter() - t
    cfg = {"latent_dim": LATENT, "node_embedding_dim": GNN_EMBED, "num_convs": GNN_CONVS,
           "supervisor_hidden_dim": SUP_HIDDEN, "lr": 1e-3, "gnn_sparse": "auto"}
    model = GNN(cfg, ds, ["subtype"], device=DEVICE)
    if not (model.n_nodes == N and model.sparse and isinstance(model._adj, dict)):
        fail(f"string scale: {model.n_nodes} nodes, sparse {model.sparse}: 'auto' must take "
             f"the edge list at {N} nodes")
    print(f"string scale: {N} nodes, {ds.edge_index.shape[1]} edges ("
          f"{int(model._adj['w'].count_nonzero())} operator entries, padded to "
          f"{model._adj['w'].numel()}), node tensor of {n} samples built in {build_s:.2f} s; "
          "gnn_sparse 'auto' took the edge list", flush=True)
    check_card_matches_cpu(model, ds, "GNN string scale (sparse GC)", reduction_bound=True)
    weight_grad_probe(ds, cfg)
    outs = {}
    for device in (DEVICE, "cpu"):
        m = GNN(cfg, ds, ["subtype"], device=device)
        m.init_params(seed=6)
        outs[device] = m.predict(ds)["subtype"]
    err = float(np.abs(outs[DEVICE] - outs["cpu"]).max())
    if not np.allclose(outs[DEVICE], outs["cpu"], **TOL):
        fail(f"string scale: eval forward differs between the card and the CPU: {err:.3e}")
    print(f"string scale: eval forward over {n} samples, card vs cpu probabilities max abs "
          f"diff {err:.3e} (tol {TOL})", flush=True)
    model.init_params(seed=6)
    step_ms = time_steps(model, ds, "GNN string scale") * 1e3
    compared = dense_vs_sparse(ds, "GC", "string scale")
    return {"nodes": N, "step_ms": step_ms, **compared}


def gnn(workdir: Path, importer_cache: ImportOnce) -> tuple:
    """The GNN: a folder of FIT_TRAIN + FIT_TEST samples whose gex rows
    (RAW_GEX genes) and cnv rows (the first RAW_CNV of them) share gene
    names, selected to GEX and CNV, and a user graph over all RAW_GEX genes;
    one GC trial of FIT_EPOCHS epochs through the training CLI with marker
    finding; its saved model served on the card and on the CPU; three steps
    card against CPU for each conv type (GAT sparse); the step time; dense
    against sparse at the folder's node count (GC and GAT); three stacked
    steps against Trainer steps and the CPU; the stacked step's time; CLI
    rounds of TRIALS suggestions batched (lr free) and one at a time, and a
    mixed round of the default space; then STRING scale. B1, B2 and B3
    launch no time. Returns each run's launches and the summary numbers."""
    from flexynesis_torch.models.gnn import GNN
    from flexynesis_torch.utils.synthetic import write_synthetic_folder, write_user_graph

    t = time.perf_counter()
    data = workdir / "gnn_data"
    write_synthetic_folder(str(data), n_train=FIT_TRAIN, n_test=FIT_TEST,
                           n_features={"gex": RAW_GEX, "cnv": RAW_CNV}, n_classes=N_CLASSES,
                           seed=2, gene_names=True)
    graph = workdir / "gnn_graph.csv"
    n_edges = write_user_graph(str(graph), RAW_GEX)
    config = workdir / "gnn_hpo.yaml"
    config.write_text(GNN_CONFIG % (LATENT, GNN_EMBED, GNN_CONVS, LR_FIXED, SUP_HIDDEN,
                                    FIT_EPOCHS, BATCH))
    print(f"gnn: wrote {FIT_TRAIN}+{FIT_TEST} samples x {RAW_GEX} gex + {RAW_CNV} cnv rows over "
          f"shared gene names and a graph of {n_edges} edges in {time.perf_counter() - t:.2f} s",
          flush=True)
    out = workdir / "gnn_out"
    extra = ("--user_graph", str(graph))
    t = time.perf_counter()
    with importer_cache:
        model, launches, log = zoo_cli_run(data, config, out, "GNN", extra)
    cli_s = time.perf_counter() - t
    zoo_launches("gnn training", launches)
    if not (2000 <= model.n_nodes <= 3000) or model.sparse or model.gnn_conv_type != "GC":
        fail(f"gnn: {model.n_nodes} nodes, sparse {model.sparse}, conv {model.gnn_conv_type}: "
             "expected 2000-3000 nodes, the dense operator and GC")
    res = model.train_result
    print(f"gnn: training CLI on {DEVICE} {cli_s:.3f} s: {model.n_nodes} nodes x "
          f"{model.n_node_feats} features, {model.nw_dataset.edge_index.shape[1]} edges in the "
          f"node set, dense GC, {res.epochs_run} epochs; launches (B1, B2, B3) {launches}; train "
          "loss by epoch " + json.dumps([round(v, 5) for v in res.history["train_loss"]])
          + "; CLI phases (host clock, s): "
          + json.dumps({k: round(v, 4) for k, v in model.cli_phases.items()}), flush=True)
    check_importances(out, "fit", model, "gnn: training CLI")
    # marker finding on the CPU at this width takes minutes: both servings
    # attribute a subsample of 4 (the card's full-cohort seconds are below)
    serve_s = serve_both(workdir, out, data / "test", "gnn", model,
                         ("--marker_sample_cap", "4"))
    cohort = nw_cohort(model, data / "test", out / "fit.artifacts.json")
    seconds = method_seconds(model, cohort, "gnn")

    for conv in ("GCN", "SAGE", "GC", "GAT"):
        sparse = conv == "GAT"  # the dense GAT's (B, N, N) scores are slow on the CPU
        tmpl = GNN(dict(model.config, gnn_sparse=sparse), cohort, ["subtype"], device="cpu",
                   gnn_conv_type=conv)
        check_card_matches_cpu(tmpl, cohort, f"GNN {conv} {'sparse' if sparse else 'dense'}")
    step_ms = time_steps(model, cohort, "GNN GC dense") * 1e3
    compared = {conv: dense_vs_sparse(cohort, conv, "gnn", cpu_too=conv == "GC")
                for conv in ("GC", "GAT")}
    h_config = {"latent_dim": LATENT, "node_embedding_dim": GNN_EMBED, "num_convs": GNN_CONVS,
                "supervisor_hidden_dim": SUP_HIDDEN, "lr": 1e-3, "epochs": GNN_TRIAL_EPOCHS,
                "batch_size": BATCH}
    check_stacked_steps(h_config, cohort, "GNN", noise=True)
    stacked_ms, busy = time_stacked_steps(h_config, cohort, TRIALS, "GNN")

    same = GNN_CONFIG % (LATENT, GNN_EMBED, GNN_CONVS, LR_FREE, SUP_HIDDEN, GNN_TRIAL_EPOCHS,
                         BATCH)
    runs, logs, launches_by = {}, {}, {"gnn_training": launches}
    with importer_cache:
        for kind, text, more in (("batched", same, ()),
                                 ("sequential", same, ("--hpo_batch", "1")),
                                 ("mixed", GNN_MIXED_CONFIG % (GNN_MIXED_EPOCHS, BATCH), ())):
            _, phases, got, logs[kind], _ = hpo_run(workdir, f"gnn_{kind}", text,
                                                    (*extra, *more), "GNN", TRIALS, data)
            zoo_launches(f"gnn {kind} round", got)
            runs[kind] = (phases, TRIALS)
            launches_by[f"gnn_{kind}"] = got
    check_round_logs("gnn", logs)
    groups = [line for line in logs["mixed"].splitlines()
              if "mixed-architecture trials concurrently" in line]
    print(f"gnn: the mixed round trained {len(groups)} padded groups (bucketed by num_convs)",
          flush=True)
    rate = round_rates("gnn", runs)
    string_s = string_cli(workdir)
    scale = string_scale()
    return launches_by, {"nodes": model.n_nodes, "trials_per_hour": rate, "step_ms": step_ms,
                         "stacked_step_ms": stacked_ms, "stacked_busy_pct": busy,
                         "dense_vs_sparse": compared, "cli_phases": model.cli_phases,
                         "marker_seconds": seconds, "serve_seconds": serve_s,
                         "string_cli": string_s, "string_scale": scale}


def build_all(names):
    """Build the kernels' libraries and the CSV reader's, one compiler per
    source (nvcc, or g++ for the reader), started together."""
    from concurrent.futures import ThreadPoolExecutor

    from flexynesis_torch.kernels import build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        libs = list(pool.map(build.build, names))
    print(f"build: {', '.join(lib.name for lib in libs)} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for lib in libs:
        log = lib.with_suffix(".log")
        if log.exists():
            print(log.read_text().strip(), flush=True)


def trial_entry(rows, label_part: str):
    """The trial axis of B1 or B2 in the kernels line: one stacked pass of
    TRIALS trials over the path's three blocks (the rows whose label holds
    ``label_part``), summed."""
    path = [r for r in rows if r["K"] == TRIALS and label_part in r["label"]]
    ops_ms, nbytes = sum(r["ops_ms"] for r in path), sum(r["bytes"] for r in path)
    bms, by = bound_ms(ops_ms, nbytes)
    return {"K": TRIALS, "launches_per_pass": sum(r["launches"] for r in path),
            "ms": sum(r["ms"] for r in path),
            "device_ms": (None if any(r["device_ms"] is None for r in path)
                          else sum(r["device_ms"] for r in path)),
            "host_ms": sum(r["host_ms"] for r in path),
            "plain_ms": sum(r["plain_ms"] for r in path), "bound_ms": bms, "bound_by": by,
            "shapes": [[r["K"], r["B"], r["F"], r["H"]] for r in path]}


def b3_trial_entry(rows):
    """B3's trial axis in the kernels line: one stacked supervised_vae
    training step of TRIALS trials, an MMD term per decoded layer (two) of
    the shared prior against each trial's batch; beside it the per-call rows
    of every trial-axis shape."""
    path = [r for r in rows if r["label"] == "train_shared"]
    ops_ms, nbytes = 2 * path[0]["ops_ms"], 2 * path[0]["bytes"]
    bms, by = bound_ms(ops_ms, nbytes)
    return {"K": TRIALS, "launches_per_stacked_step": 2, "launches_per_stacked_validation": 2,
            "ms": 2 * path[0]["ms"],
            "device_ms": None if path[0]["device_ms"] is None else 2 * path[0]["device_ms"],
            "host_ms": 2 * path[0]["host_ms"], "plain_ms": 2 * path[0]["plain_ms"],
            "bound_ms": bms, "bound_by": by,
            "per_call": [{k: r[k] for k in ("label", "shape", "per_trial", "ms", "device_ms",
                                             "host_ms", "plain_ms", "bound_ms", "bound_by",
                                             "max_abs_err")} for r in rows]}


def kernel_entry(name, source, replaces, rows, path_rows, launches, by_path, per_path=1,
                 extra=None):
    """The kernel's line: times and work summed over ``path_rows`` (the calls
    of one pass of its path), times ``per_path`` where the pass repeats them;
    ``extra`` adds keys of the kernel's own."""
    ops_ms = per_path * sum(r["ops_ms"] for r in path_rows)
    nbytes = per_path * sum(r["bytes"] for r in path_rows)
    bms, by = bound_ms(ops_ms, nbytes)
    entry = {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches,
        "launches_by_path": by_path,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": per_path * sum(r["ms"] for r in path_rows),
        "device_ms": (None if any(r["device_ms"] is None for r in path_rows)
                      else per_path * sum(r["device_ms"] for r in path_rows)),
        "plain_ms": per_path * sum(r["plain_ms"] for r in path_rows),
        "bound_ms": bms,
        "bound_by": by,
        "library_ms": None,
        "shapes": [r.get("shape") or [r["B"], r["F"], r["H"]] for r in path_rows],
    }
    if "host_ms" in path_rows[0]:
        entry["host_ms"] = per_path * sum(r["host_ms"] for r in path_rows)
    if "addmm_ms" in path_rows[0]:
        entry["gemm_only_addmm_ms"] = sum(r["addmm_ms"] for r in path_rows)
    entry.update(extra or {})
    return entry


def check_kernels():
    """Build the kernels, then hold B2, B1 and B3 against their plain
    versions at their path shapes and more; returns the training path's
    shapes, B2's rows and passes, and the per-shape rows of B1, B3 and the
    MMD term."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_all(["fused_linear_eval", "fused_linear_train", "mmd_kernel", "fastcsv"])

    rows, passes = check_b2()

    h_gex, h_cnv = int(GEX * HIDDEN_FACTOR), int(CNV * HIDDEN_FACTOR)
    train_shapes = [
        ("encoder_gex", (BATCH, GEX, h_gex)),
        ("encoder_cnv", (BATCH, CNV, h_cnv)),
        ("head_subtype", (BATCH, LATENT, SUP_HIDDEN)),
    ]
    # beyond the path: every cluster size the planner picks (8 at the
    # encoders, 1 at the head; 2 and 4 at shallower F), an F and H that take
    # 4-byte copies and a ragged last slice, batches of 32, 128 and 4096 rows
    b1_extra = [("split2_f128", (BATCH, 128, h_gex)), ("split4_f256", (BATCH, 256, h_gex)),
                ("unaligned", (BATCH, GEX - 1, h_gex + 1)),
                ("encoder_gex_b32", (32, GEX, h_gex)), ("encoder_gex_b128", (128, GEX, h_gex)),
                ("ragged", (37, 129, 67)), ("one_row", (1, LATENT, SUP_HIDDEN)),
                ("split_b4096", (4096, GEX, h_gex))]
    b1_rows = check_b1(train_shapes + b1_extra, [shape for _, shape in train_shapes])

    # B3: one MMD term holds the 200-draw prior against the latent batch
    val_rows = int(math.ceil(FIT_TRAIN * VAL_SIZE))
    b3_train = [("prior_prior", (200, 200, LATENT)), ("z_z", (BATCH, BATCH, LATENT)),
                ("prior_z", (200, BATCH, LATENT))]
    b3_extra = [(f"z_z_val{val_rows}", (val_rows, val_rows, LATENT)),
                (f"prior_z_val{val_rows}", (200, val_rows, LATENT)),
                ("ragged", (37, 129, 17)), ("one_row", (1, 200, 16)),
                ("latent128", (200, BATCH, 128)), ("many_blocks", (4096, 4096, LATENT))]
    b3_rows = check_b3(b3_train + b3_extra, [shape for _, shape in b3_train])
    # the VAE's call: one MMD term per decoded layer, of the prior against the
    # batch in every step and against the validation split in validation
    term_train = [("train", (200, BATCH, LATENT))]
    term_rows = check_mmd_term(
        term_train + [(f"val{val_rows}", (200, val_rows, LATENT)), ("ragged", (37, 129, 17)),
                      ("one_row", (1, 1, 16))],
        [shape for _, shape in term_train])
    trial_rows = check_trial_kernels() + [dict(r, kernel="B3") for r in check_b3_trials()]
    return train_shapes, rows, passes, b1_rows, b3_rows, term_rows, trial_rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if not (REPO / "flexynesis_torch" / "csrc").is_dir():
        print(f"chip_smoke: {REPO} holds no flexynesis_torch checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))

    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    t_start = time.perf_counter()
    train_shapes, rows, passes, b1_rows, b3_rows, term_rows, trial_rows = check_kernels()

    workdir = REPO / "build" / "chip_smoke"
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    serve_b2 = serve(workdir)
    importer_cache = ImportOnce()
    with importer_cache:  # phase 5 imports its folder once for the trial phase too
        (train_b1, train_b2), b2_train_rows, cohort = train(workdir)
    # B2 at the shapes the training phase gave it that serving did not
    checked = {(r["B"], r["F"], r["H"]) for r in rows}
    rows += check_kernel([(f"{n}_n{B}", (B, F, H)) for B in b2_train_rows
                          for n, (F, H) in b2_blocks() if (B, F, H) not in checked])
    hpo_launches, hpo_summary = train_trials(workdir, importer_cache, cohort)
    vae_launches, vae_summary = vae_trials(workdir, importer_cache, cohort)
    vae_b3 = train_vae(workdir, "supervised_vae", FIT_EPOCHS)
    cm_b3 = train_vae(workdir, "CrossModalPred", CM_EPOCHS,
                      ("--input_layers", "gex", "--output_layers", "cnv"), timed=False)
    marker_summary = markers(workdir)
    marker_b1, marker_b2, marker_b3 = marker_summary.pop("launches")
    triplet_launches, triplet_summary = triplet(workdir, importer_cache, cohort)
    gnn_launches, gnn_summary = gnn(workdir, importer_cache)
    zoo = {**triplet_launches, **gnn_launches}

    trial_b1 = [r for r in trial_rows if r["kernel"] == "B1"]
    trial_b2 = [r for r in trial_rows if r["kernel"] == "B2"]
    trial_b3 = [r for r in trial_rows if r["kernel"] == "B3"]
    entries = [
        kernel_entry("fused_linear_bn_relu", "flexynesis_torch/csrc/fused_linear_train.cu",
                     "flexynesis_tpu/ops/pallas/fused_linear.py:115", b1_rows + trial_b1,
                     b1_rows[:len(train_shapes)],  # one training forward
                     train_b1, {"training": train_b1,
                                **{k: v[0] for k, v in {**hpo_launches, **vae_launches}.items()},
                                "default_directpred_markers": marker_b1,
                                **{k: v[0] for k, v in zoo.items()}},
                     extra={"trial_axis": trial_entry(trial_b1, "shared_x")}),
        kernel_entry("fused_linear_bn_relu_eval", "flexynesis_torch/csrc/fused_linear_eval.cu",
                     "flexynesis_tpu/ops/pallas/fused_linear.py:223", rows + trial_b2,
                     rows[:len(b2_blocks())],  # one eval forward over the cohort
                     serve_b2, {"serving": serve_b2, "training": train_b2,
                                **{k: v[1] for k, v in {**hpo_launches, **vae_launches}.items()},
                                "default_directpred_markers": marker_b2,
                                **{k: v[1] for k, v in zoo.items()}},
                     extra={"gemm_only_addmm_device_ms": passes["cohort"]["addmm_device_ms"],
                            "passes": passes, "trial_axis": trial_entry(trial_b2, "_val")}),
        kernel_entry("gaussian_kernel_mean", "flexynesis_torch/csrc/mmd_kernel.cu",
                     "flexynesis_tpu/ops/pallas/mmd_kernel.py:66", b3_rows + term_rows + trial_b3,
                     term_rows[:1], vae_b3,
                     {"supervised_vae_training": vae_b3, "crossmodal_training": cm_b3,
                      **{k: v[2] for k, v in {**hpo_launches, **vae_launches}.items()},
                      "default_directpred_markers": marker_b3,
                      **{k: v[2] for k, v in zoo.items()}},
                     per_path=2,  # one training step: an MMD term per decoded layer
                     extra={"trial_axis": b3_trial_entry(trial_b3)}),
    ]
    print("trials: summary " + json.dumps(hpo_summary), flush=True)
    print("vae trials: summary " + json.dumps(vae_summary), flush=True)
    print("markers: summary " + json.dumps(marker_summary), flush=True)
    print("triplet: summary " + json.dumps(triplet_summary), flush=True)
    print("gnn: summary " + json.dumps(gnn_summary), flush=True)
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
