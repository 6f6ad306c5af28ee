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
   padded entries exactly zero), the card's rounds through the SR-bf16 Adam
   kernel (``csrc/sr_adam.cu``, two launches a step), and the same steps
   through the kernel against the card's plain chain and its copy back
   (fused multiply-adds rounded once) bit for bit; one stacked step's time
   and a profiled run; the kernel's time per stacked step (K = 16
   DirectPred and supervised_vae, the padded round) beside its plain
   chain, its host issue and its bytes bound; then three training CLI runs
   of 16 suggestions (the kernel 2 launches per stacked step in the
   batched and the mixed round): a
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
   against sparse there);
11. fine-tuning, covariates and early fusion, and ``--hpo_checkpoint`` (after
   phase 10, on phase 5's folder): B1 and B2 against their plain versions at
   the covariate encoder (F = H = 2), the early-fusion encoder (gex, cnv and
   age: F = 3001, H = 900) at 64 and 400 rows, and the fine-tuning grid's
   K = 45 trials with x per trial (32-row steps, 20-row validations) at the
   headline gex block, the early-fusion encoder, the head and the covariate
   block (one launch per call, two calls bit for bit); a fused DirectPred at
   the headline width through the training CLI with ``--covariates age
   --fusion_type early --finetuning_samples 100``: B1 and B2 launches grow
   with the grid's steps and validations, not with its 45 trials, every leaf
   of a frozen subtree is bit-identical after the final fit (and after a fit
   with each freeze configuration), and the fine-tuned model serves alike on
   the card and on the CPU; the same fine-tuning in inference mode, whose
   saved model serves alike too; three grid steps of K = 45 on the card
   against the CPU, and the grid step's time; a same-architecture round of
   16 suggestions with ``--hpo_checkpoint`` in a subprocess, killed once its
   round checkpoint appears and rerun: the rerun prints the resume line and
   tells the GP the same 16 losses, bit for bit, as an uninterrupted run;
12. HDF5, ``--profile`` and the classical baselines (after phase 11): phase
   5's folder converted by ``python -m flexynesis_torch.csv_to_h5``'s
   converter, each file read back by the port's HDF5 reader bit for bit
   against the CSV reader (the seconds of each), the h5py-written fixture
   ``tests/fixtures/h5/gex.h5`` against its CSV twin; phase 5's run on the
   ``.h5`` folder (the same selected features and B1/B2 launches as the CSV
   run, test probabilities within rtol/atol 1e-4 of it, the saved model
   served alike on the card and the CPU), then with ``--profile``
   (``fit.profile.json`` with JAX's phase names, a Chrome trace naming B1
   and B2, the profiler's overhead); then on a reduced folder (300 + 100
   samples, gex 200 and cnv 100 selected; the cuts are printed) a fused
   DirectPred with and without ``--evaluate_baseline_performance`` (equal
   B1/B2 launches), ``--model_class SVM``, ``XGBoost`` and
   ``RandomSurvivalForest`` timed (B1, B2 and B3 never), the SVM grid's
   tables on the card against the CPU (within 1e-10: both solve a float64
   kernel matrix) and a GradientBoosting fit (training and held-out rows
   within 1e-9), and one fit of
   each estimator at its grid's middle point at the headline width (the
   1600 training rows of a fold of phase 5's import x 3000 features), timed;
13. the analysis surface (after phase 12; no kernel of the port lies on it,
   B1, B2 and B3 launch no time): (a) ``python -m
   flexynesis_torch.coexpression``'s entry point, Spearman then Pearson
   (threshold 0.5, top-k 5), over 20,000 genes x 1,000 samples with 400
   planted modules of 25 genes (the 10,000 others independent): every
   planted pair found, the seconds of reading, ranking, the Gram products
   with edge selection, the gather and the write, peak allocated memory and
   the edge count beside the Gram's FLOP bound; the same Pearson run with
   ``--max_genes 12000``: its genes the most variable, its edges the full
   network's among them, its seconds by part; then the sweep over 4,000
   genes of Poisson counts (ties) on the card against the CPU, both
   methods: the same edges away from the threshold, scores within 1e-5;
   (b) the GNN tutorial's flow on phase 10's GNN folder: a Pearson network
   (0.3, top-k 5) of its train/gex.csv (none from the raw file, whose every
   gene holds NaN cells, as in JAX; so from the file with each gene's NaN
   cells set to its median), then a GNN through the training CLI with
   ``--user_graph`` on it (one trial, 2 epochs): its node and edge counts and
   its output files; (c) an unfused DirectPred with a survival head
   (OS_STATUS / OS_MONTHS) on phase 5's folder with marker finding, then the
   survival tutorial's steps on its test risk on the card and on the CPU
   (the optimal cut-off and its log-rank test, Kaplan-Meier, ``build_cox_model``
   on the top 5 markers with the AUC at the median time): the same cut-off
   and fold C-indices, Cox coefficients and standard errors within 1e-8
   relative; (d) on that run's test embeddings, silhouette-optimal KMeans
   over k = 2..10, Louvain on the 15-NN graph and AMI/ARI against the
   subtypes, card against CPU (the same labels and k, silhouettes within
   1e-8), and the Sinkhorn transport cost between the cohort's halves with
   a shift planted in one, and their optimal transport alignment, card
   against CPU (1e-5 relative, 1e-4), the alignment lowering the cost.
14. the mesh, the 8-bit trial moments and GradientShap's input noise (after
   phase 13, on phase 5's test cohort): (a) SR-Adam with int8 moments at
   the full-width DirectPred leaves, K = 16, card against CPU, alone on the
   same gradients and over three stacked steps (``check_int8_steps``), then
   16-trial ``ParallelTrials`` rounds with int8 and bf16 moments side by
   side, their step times and peak memory; (b) GradientShap with stdev 0.1
   card against CPU; (c) B1, B2 and B3 giving a shard's trials the round's
   bits (``check_shard_launches``), then rounds of 16 (a fused DirectPred
   whose shards' trials stall apart, a fused supervised_vae) and the
   45-trial fine-tuning grid split over shards of the one card against the
   unsharded rounds, each shard launching as the round does for its
   trials; (d) both attribution methods over 10,250 samples split over two
   shards against the unsharded run; (e) a data-parallel fit over a
   one-rank NCCL group (``distributed.initialize``) against the plain fit,
   bit for bit, and ``partition_trials`` over it;
15. joblib artifacts (after phase 14; the card's machine has neither joblib
   nor sklearn): (a) phase 5's training command without ``--safetensors``,
   the CLI's default (phase 5's import reused, 3 epochs): B1 and B2 launches
   as its steps and validations give them, ``fit.artifacts.joblib`` written
   and no JSON; (b) the run's 2000-sample training cohort served from that
   file and from a ``.artifacts.json`` the port writes from the state it
   loads to: the same tables bit for bit, B2 6 launches each; (c) the
   JAX-trained fused DirectPred of ``tests/fixtures/joblib`` served from its
   ``.joblib`` and its ``.json`` on the card (bit for bit) and on the CPU
   (within rtol/atol 1e-4); (d) what the codec reads and writes back loads
   to the same state, and the median seconds of the joblib reader and writer (the codec alone
   and with the state conversion) beside the JSON ones.
16. the tuner's and feature selection's library options (after phase 15, on
   phase 5's folder and 2000-sample import): (a) ``HyperparameterTuning``
   with ``cv_splits=3`` and ``parallel_folds`` off, 2 suggestions asked as
   one batch of 2, 3 epochs: 3 fresh fits a suggestion over
   ``kfold_indices`` and the full-set retrain, B1 and B2 launches as the
   folds' steps and validations predict, no ask session; (b) B1 and B2 at
   the K = 12 shapes of a 4 x 3 CV round and B3's MMD term at the K = 6
   shapes of a 2 x 3 one (x and the prior per trial) against their plain
   versions; one stacked step of the 4 x 3 DirectPred group against each
   suggestion's own 3-fold round (the same rows, losses within rtol/atol
   1e-4), the group's round against each suggestion's own round (fold means
   within rtol 1e-2), its B1 and B2 launches, and the 2 x 3 supervised_vae
   round's B3 launches; (c) the Laplacian score of the 2000 x 4000 raw gex
   matrix: the heat kernel on the card against the CPU, and
   ``laplacian_score_sharded`` over ``[cuda:0, cuda:0]`` against the
   unsharded score, within rtol 1e-4 / atol 1e-6, with synchronised
   seconds (the kNN score card against CPU too, unless near-tied neighbours
   within float32's error in d^2 let the devices' graphs part); (d) the
   ``data``, ``ops``, ``train`` and ``models`` facades resolve every name
   to the port, with no JAX module loaded.

Each phase prints its seconds as it ends, and all of them on one line
before the kernels line (``phase seconds: {...}``).

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
the later phases for all three) and read just after. The output ends
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
SEQ_TRIALS = 4  # the one-at-a-time rounds' suggestions (--hpo_batch 1), cut from 16
DEVICE = "cuda"  # the training phase's device (a CPU rehearsal sets "cpu")
# the CUDA functions of the port's kernels, as the profiles name them: B1
# (and its merge launch above 64 rows), B2 and B3
KERNEL_FUNCTIONS = ("fused_linear_bn_relu_train_split_kernel", "bn_relu_merge_kernel",
                    "fused_linear_bn_relu_eval_kernel", "gaussian_kernel_mean_kernel",
                    "sr_adam_norm_kernel", "sr_adam_update_kernel")


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


def kernel_device_ms(fn, names, launches: int, reps: int = 20):
    """(device ms per call, the calls' kernels found) of ``fn``, whose every
    call launches ``launches`` kernels named in ``names``: the sum of those
    kernels' own device times in a torch.profiler trace of ``reps`` calls,
    over ``reps``. The trace's first ``reps`` calls warm the profiler up and
    are not read. Fails unless the read calls' kernels are all found, so
    that the time is never a part of the calls'."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            prof.step()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
              and any(n in e.key for n in names)]
    found = sum(e.count for e in events)
    if found != launches * reps:
        fail(f"the profiler found {found} launches of {', '.join(names)} in {reps} calls of "
             f"{launches}")
    return sum(e.self_device_time_total for e in events) / reps / 1e3, found


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


def trial_blocks():
    """(name, F, H) of the fused blocks of a DirectPred step: the two
    encoders and the head."""
    return [("encoder_gex", GEX, int(GEX * HIDDEN_FACTOR)),
            ("encoder_cnv", CNV, int(CNV * HIDDEN_FACTOR)),
            ("head_subtype", LATENT, SUP_HIDDEN)]


def check_trial_kernels(cases=None):
    """B1 and B2 with a trial axis against their plain versions: B1 at the
    three blocks of a 16-trial DirectPred training step (x shared and x per
    trial), B2 at the three blocks of a 16-trial validation of 400 rows (x
    shared), K = 1 (the same bits as the call without the axis) and a ragged
    K = 3, or at ``cases`` ((kernel, label, K, B, F, H, x per trial)); within
    TOL, two calls bit for bit, one launch per stacked call (two above 64
    rows for B1), B1's gradients against autograd through the plain version
    at the 16-trial training blocks. Prints CUDA-event, device and host-issue
    times per stacked call and the bound; returns per-shape rows."""
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
    h_gex = int(GEX * HIDDEN_FACTOR)
    blocks = trial_blocks()
    val_rows = int(math.ceil(FIT_TRAIN * VAL_SIZE))
    if cases is None:
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


def check_b3_trials(cases=None):
    """B3's MMD term with a trial axis against its plain version: the
    16-trial training term (the 200-draw prior against each trial's 64-row
    batch) and validation term (against the 400-row split), the prior shared
    by the trials (read at a trial stride of 0) and per trial, K = 1 and a
    ragged K = 3, or at ``cases`` ((label, K, N, M, d, prior per trial)):
    the means within B3_TOL and the MMD within MMD_TOL of
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
    if cases is None:
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


def read_outputs(outdir: Path, n: int = N_TEST, classes: int = N_CLASSES, latent: int = LATENT):
    """(samples, embeddings, probabilities, stats rows) of an inference run
    over ``n`` samples and ``classes`` classes, checked for shape and finiteness."""
    import numpy as np
    from flexynesis_torch.utils.csvio import read_matrix, read_table

    samples, _, emb = read_matrix(str(outdir / "smoke.embeddings_test.csv"))
    if emb.shape != (n, latent) or not np.isfinite(emb).all():
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


def compare_outputs(out_card: Path, out_cpu: Path, n: int, classes: int, phase: str,
                    latent: int = LATENT):
    """Hold the card's inference outputs against the CPU run's; returns the
    card run's stats rows."""
    import numpy as np

    s_gpu, emb_gpu, p_gpu, stats = read_outputs(out_card, n, classes, latent)
    s_cpu, emb_cpu, p_cpu, _ = read_outputs(out_cpu, n, classes, latent)
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
    want, n_fit, b1_per_step = expected_launches(model)
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


def expected_launches(model):
    """((B1, B2) launches, fitting rows, B1 launches per step) of a fused
    DirectPred's one-trial training CLI run at batch BATCH: B1 in every
    step, B2 in every validation and evaluation forward."""
    import numpy as np
    from flexynesis_torch.kernels.fused_linear import ROW_TILE

    res = model.train_result
    n = len(next(iter(model.ann.values())))
    n_fit = n - int(np.ceil(n * VAL_SIZE))
    steps = res.epochs_run * (n_fit // BATCH)
    # a batch beyond one row tile adds the split reduction's merge launch
    b1_per_step = B1_PER_STEP * (1 if BATCH <= ROW_TILE else 2)
    return ((b1_per_step * steps, B2_PER_FORWARD * (res.epochs_run + EVAL_FORWARDS)),
            n_fit, b1_per_step)


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
    within their bound); the padded entries exactly zero on both devices.
    (3) On the card, three steps of each round through ``_Round.step``'s
    in-place kernel path (``kernels/sr_adam.py``, two launches a step)
    against the same round on the plain chain and its copy back, with the
    plain chain's fused multiply-adds rounded once (``fma_rn``) and its norm
    summed in float64 (``global_norm_f64``): losses, parameters and moments
    bit for bit."""
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

    # (3) _Round.step's in-place kernel path against the card's plain chain
    # and its copy back, the plain chain's fused multiply-adds rounded once
    # and its norm summed in float64, as the kernel sums it (the model's
    # gradients clip)
    from flexynesis_torch.kernels import sr_adam as kernel
    from flexynesis_torch.ops import sr_adam as sr_ops
    from flexynesis_torch.parallel import trials

    for name in rounds["card"]:
        runs = {}
        for path in ("kernel", "plain"):
            r, seeds = _sr_rounds(config, cohort, DEVICE)[name]
            data = r.model.make_batch(cohort)
            before = kernel.FusedSRAdam.launches
            saved = trials.fused_update_applies, sr_ops._fma, sr_ops.global_norm_f32
            if path == "plain":
                trials.fused_update_applies = lambda params, state: False
                sr_ops._fma, sr_ops.global_norm_f32 = kernel.fma_rn, kernel.global_norm_f64
            try:
                losses = torch.stack([r.step(_gather(data, p.to(DEVICE)), seed.to(DEVICE))
                                      for p, seed in zip(perm, seeds)])
            finally:
                trials.fused_update_applies, sr_ops._fma, sr_ops.global_norm_f32 = saved
            runs[path] = (r, losses, kernel.FusedSRAdam.launches - before)
        (fr, fl, fn), (pr, pl, pn) = runs["kernel"], runs["plain"]
        if fn != 3 * kernel.LAUNCHES_PER_STEP or pn != 0:
            fail(f"trials: {name} SR-bf16 steps launched the kernel {fn} and {pn} times, "
                 f"expected {3 * kernel.LAUNCHES_PER_STEP} and 0")
        if not torch.equal(fl, pl):
            fail(f"trials: {name} in-place SR-bf16 steps: losses {fl.tolist()} against the "
                 f"plain chain's {pl.tolist()}")
        for i, (a, b) in enumerate(zip([*fr.views, *fr.opt_state.m, *fr.opt_state.v],
                                       [*pr.views, *pr.opt_state.m, *pr.opt_state.v])):
            if not torch.equal(_bits(a), _bits(b)):
                fail(f"trials: {name} in-place SR-bf16 steps: leaf {i} of (parameters, m, v) "
                     "differs from the plain chain with single-rounded fused multiply-adds")
        if fr.masks is not None:
            _padded_zero(fr, f"trials: {name} in-place SR-bf16 steps")
        print(f"trials: 3 in-place SR-bf16 stacked steps ({name}, K={fr.K}, {len(fr.views)} "
              f"leaves): the kernel ({fn} launches) = the card's plain chain and copy back bit "
              "for bit (fused multiply-adds rounded once, the norm summed in float64)",
              flush=True)


def time_sr_adam(config, cohort):
    """The SR-bf16 Adam kernel's rows of the kernels line: one stacked
    step's update of every leaf of a K = TRIALS same-architecture DirectPred
    and supervised_vae round at the headline width, and of the padded round
    of MIXED_GROUP, on fixed 1e-5 N(0, 1) gradients: CUDA-event time,
    profiler device time, host issue, the plain chain's time
    (``sr_adam_step`` and the copy back), launches a step and the bytes
    bound (g and the mask read once, p, m and v read and written once, each
    in its own type)."""
    import numpy as np
    import torch
    from flexynesis_torch.kernels.sr_adam import FusedSRAdam
    from flexynesis_torch.models import MODEL_REGISTRY
    from flexynesis_torch.ops.sr_adam import sr_adam_step
    from flexynesis_torch.parallel.trials import _init_stacked, _Round

    def same(model_name):
        m = MODEL_REGISTRY[model_name](config, cohort, target_variables=["subtype"],
                                       device=DEVICE)
        params, buffers = _init_stacked(m, np.zeros(TRIALS, np.int64))
        return _Round(m, params, buffers, lrs=np.geomspace(1e-4, 1e-2, TRIALS),
                      seeds=[0] * TRIALS)

    rounds = {"directpred": same("DirectPred"), "supervised_vae": same("supervised_vae"),
              "padded": _sr_rounds(config, cohort, DEVICE)["padded"][0]}
    gen = torch.Generator(device=DEVICE).manual_seed(21)
    rows = []
    for label, r in rounds.items():
        grads = [torch.randn(v.shape, generator=gen, device=DEVICE) * 1e-5 for v in r.views]
        seed = torch.randint(0, 2 ** 32, (r.K,), generator=gen, device=DEVICE)
        masks = r.masks or [None] * len(r.views)
        plan = FusedSRAdam(r.views, r.opt_state, r.masks)
        state = [r.opt_state]

        def fused():
            state[0] = plan.step(state[0], grads, r.lrs, seed)

        def plain():
            new, _ = sr_adam_step(r.views, state[0], grads, r.lrs, seed, masks=r.masks,
                                  trial_axis=True)
            for v, x in zip(r.views, new):
                v.copy_(x)

        before = FusedSRAdam.launches
        fused()
        torch.cuda.synchronize()
        launches = FusedSRAdam.launches - before
        nbytes = sum(v.numel() * (4 + 2 * (v.element_size() + m.element_size() + w.element_size())
                                  + (4 if k is not None else 0))
                     for v, m, w, k in zip(r.views, r.opt_state.m, r.opt_state.v, masks))
        bms, by = bound_ms(0.0, nbytes)
        row = {"label": label, "K": r.K, "leaves": len(r.views),
               "elements": sum(v.numel() for v in r.views), "launches_per_step": launches,
               "ms": cuda_ms(fused, 20), "host_ms": host_ms(fused), "plain_ms": cuda_ms(plain, 5),
               "bytes": nbytes, "bound_ms": bms, "bound_by": by}
        row["device_ms"], found = kernel_device_ms(
            fused, ("sr_adam_norm_kernel", "sr_adam_update_kernel"), launches)
        print(f"trials: SR-bf16 Adam kernel, one stacked step ({label}, K={r.K}, "
              f"{row['leaves']} leaves, {row['elements']} elements): {launches} launches, "
              f"CUDA events {fmt_ms(row['ms'])}, device {fmt_ms(row['device_ms'])} (its "
              f"{found} kernels of 20 steps), host issue {fmt_ms(row['host_ms'])}, "
              f"plain chain {fmt_ms(row['plain_ms'])}, bound {fmt_ms(bms)} ({by}, "
              f"{nbytes / 1e6:.1f} MB)", flush=True)
        rows.append(row)
    return rows


def sr_adam_entry(rows, by_path):
    """The SR-bf16 Adam kernel's line: one stacked step of the headline
    DirectPred round (K = TRIALS), beside the other rounds' rows."""
    head = rows[0]
    return {"name": "sr_adam_step", "route": "cuda", "source": "flexynesis_torch/csrc/sr_adam.cu",
            "replaces": "none: flexynesis_tpu/ops/sr_adam.py::sr_adam_step is plain jnp, "
                        "fused by XLA",
            "launches_per_stacked_step": head["launches_per_step"],
            "launches_by_path": by_path,
            **{k: head[k] for k in ("ms", "device_ms", "host_ms", "plain_ms", "bound_ms",
                                    "bound_by")},
            "library_ms": None, "rounds": rows}


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


# the SR-bf16 Adam kernel's launches in each hpo_run, by run name
SR_LAUNCHES = {}


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
    from flexynesis_torch.kernels.sr_adam import FusedSRAdam

    config = workdir / f"{name}.yaml"
    config.write_text(config_text)
    out = workdir / f"{name}_out"
    args = train_args(data or workdir / "fit_data", config, out, DEVICE, model_class)
    n_iter = n_iter or TRIALS
    args[args.index("--hpo_iter") + 1] = str(n_iter)
    torch.cuda.reset_peak_memory_stats()
    b1.launches = b2.launches = b3.launches = 0
    sr_before = FusedSRAdam.launches
    with Tee() as log:
        model = run_training(*parse_args([*args, *extra]))
    launches = (b1.launches, b2.launches, b3.launches)
    SR_LAUNCHES[name] = FusedSRAdam.launches - sr_before
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    missing = [f for f in ("fit.stats.csv", "fit.predicted_labels.csv", "fit.embeddings_test.csv",
                           "fit.final_model.safetensors") if not (out / f).exists()]
    if missing:
        fail(f"trials: the {name} CLI run did not write {missing}")
    phases = model.cli_phases
    print(f"trials: {name}: CLI phases (host clock, s): "
          + json.dumps({k: round(v, 4) for k, v in phases.items()})
          + f"; {n_iter} trials in hpo_fit: {n_iter / phases['hpo_fit'] * 3600:.0f} trials/h; "
          f"launches B1 {launches[0]}, B2 {launches[1]}, B3 {launches[2]}, SR-bf16 Adam "
          f"{SR_LAUNCHES[name]}; peak allocated "
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
    sr_rows = time_sr_adam(h_config, cohort)

    same = TRIAL_CONFIG % (LATENT, HIDDEN_FACTOR, SUP_HIDDEN, FIT_EPOCHS, BATCH)
    with importer_cache:
        model, phases, launches, log, out = hpo_run(workdir, "hpo_batched", same)
        seq_model, seq_phases, seq_launches, _, _ = hpo_run(
            workdir, "hpo_sequential", same, ("--hpo_batch", "1"), n_iter=SEQ_TRIALS)
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
    seq_want = (B1_PER_STEP * SEQ_TRIALS * round_steps,
                B2_PER_FORWARD * (SEQ_TRIALS * FIT_EPOCHS + EVAL_FORWARDS), 0)
    if seq_launches != seq_want:
        fail(f"trials: sequential launches (B1, B2) = {seq_launches}, expected {seq_want}")
    mixed_steps = MIXED_EPOCHS * (n_fit // BATCH)  # patience 10 > 5 epochs
    for run, steps in (("hpo_batched", round_steps), ("hpo_mixed", mixed_steps)):
        if SR_LAUNCHES[run] != 2 * steps:
            fail(f"trials: {run} launched the SR-bf16 Adam kernel {SR_LAUNCHES[run]} times, "
                 f"expected 2 per stacked step x {steps}")
    print(f"trials: {TRIALS} trials batched: B1 {launches[0]} launches = {B1_PER_STEP} x "
          f"({round_steps} stacked steps + {retrain_steps} retrain steps), B2 {launches[1]}; "
          f"one at a time: B1 {seq_launches[0]} = {B1_PER_STEP} x {SEQ_TRIALS} x {round_steps}, "
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
    rate = {k: n / p["hpo_fit"] * 3600
            for k, p, n in (("batched", phases, TRIALS), ("sequential", seq_phases, SEQ_TRIALS),
                            ("mixed", mixed_phases, TRIALS))}
    print(f"trials: hpo_fit trials/h: batched {rate['batched']:.0f}, one at a time "
          f"{rate['sequential']:.0f} ({rate['batched'] / rate['sequential']:.2f}x), mixed "
          f"architectures ({MIXED_EPOCHS} epochs, unfused) {rate['mixed']:.0f}; best "
          f"val-chosen lr batched {model.config['lr']:.3g}, sequential "
          f"{seq_model.config['lr']:.3g}", flush=True)
    return ({"hpo_batched": launches, "hpo_sequential": seq_launches,
             "hpo_mixed": mixed_launches},
            {"trials_per_hour": rate, "stacked_step_ms": step_ms, "stacked_busy_pct": busy,
             "sr_adam": sr_rows})


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
            workdir, "vae_sequential", vae_same, ("--hpo_batch", "1"), "supervised_vae",
            SEQ_TRIALS)
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
    seq_want = (0, 0, n_dec * SEQ_TRIALS * (round_steps + VAE_TRIAL_EPOCHS))
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

    rate = {k: n / p["hpo_fit"] * 3600
            for k, p, n in (("batched", phases, TRIALS), ("sequential", seq_phases, SEQ_TRIALS),
                            ("crossmodal_mixed", cm_phases, TRIALS))}
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
                ("sequential", same, ("--hpo_batch", "1"), SEQ_TRIALS),
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
        for kind, text, more, n_iter in (
                ("batched", same, (), TRIALS),
                ("sequential", same, ("--hpo_batch", "1"), SEQ_TRIALS),
                ("mixed", GNN_MIXED_CONFIG % (GNN_MIXED_EPOCHS, BATCH), (), TRIALS)):
            _, phases, got, logs[kind], _ = hpo_run(workdir, f"gnn_{kind}", text,
                                                    (*extra, *more), "GNN", n_iter, data)
            zoo_launches(f"gnn {kind} round", got)
            runs[kind] = (phases, n_iter)
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


# phase 11: fine-tuning, covariates and early fusion, --hpo_checkpoint
FT_SAMPLES = 100  # --finetuning_samples: 5 folds of 80 training and 20 validation rows
FT_FOLDS, FT_CELLS = 5, 9  # 3 lrs x 3 freeze configurations
FT_K = FT_CELLS * FT_FOLDS  # the grid's trials
FT_BATCH = 32  # the grid's steps: min(32, 80 training rows)
FT_VAL = FT_SAMPLES // FT_FOLDS
FUSED_F = GEX + CNV + 1  # the early-fusion encoder: gex, cnv and age
FUSED_H = int(FUSED_F * HIDDEN_FACTOR)
FT_BLOCKS = 2  # the early-fusion encoder and the head
FT_ARGS = ("--covariates", "age", "--fusion_type", "early",
           "--finetuning_samples", str(FT_SAMPLES))
CKPT_EPOCH = 5  # the round checkpoint's cadence (ParallelTrials' epochs_per_eval)


def check_finetune_kernels():
    """B1 and B2 against their plain versions at phase 11's shapes: the
    covariate encoder (F = H = 2, 4-byte copies) and the early-fusion encoder
    (gex, cnv and age: F = 3001, H = 900) at the 64-row batch and the
    400-row validation; then the fine-tuning grid's K = 45 trials with x per
    trial (each fold its rows: 32-row steps, 20-row validations) at the
    headline gex block, the early-fusion encoder, the head and the covariate
    block. Returns (B1 rows, B2 rows, trial rows)."""
    h_gex = int(GEX * HIDDEN_FACTOR)
    shapes = [("covariate_encoder", (BATCH, 2, 2)), ("covariate_encoder_n400", (400, 2, 2)),
              ("early_fusion_encoder", (BATCH, FUSED_F, FUSED_H)),
              ("early_fusion_encoder_n400", (400, FUSED_F, FUSED_H))]
    b1_rows = check_b1(shapes, [])
    b2_rows = check_kernel(shapes)
    cases = [("B1", "grid_gex_x_per_trial", FT_K, FT_BATCH, GEX, h_gex, True),
             ("B1", "grid_all_x_per_trial", FT_K, FT_BATCH, FUSED_F, FUSED_H, True),
             ("B1", "grid_head_x_per_trial", FT_K, FT_BATCH, LATENT, SUP_HIDDEN, True),
             ("B1", "grid_covariates_x_per_trial", FT_K, FT_BATCH, 2, 2, True),
             ("B2", f"grid_gex_val{FT_VAL}", FT_K, FT_VAL, GEX, h_gex, True),
             ("B2", f"grid_all_val{FT_VAL}", FT_K, FT_VAL, FUSED_F, FUSED_H, True),
             ("B2", f"grid_head_val{FT_VAL}", FT_K, FT_VAL, LATENT, SUP_HIDDEN, True)]
    return b1_rows, b2_rows, check_trial_kernels(cases)


class FineTuneWatch:
    """Records, while active, each fine-tuning grid's results
    (``vmapped_grid_fit``), each ``FineTuner`` and each final fit's start and
    fitted states with its freeze configuration."""

    def __enter__(self):
        from flexynesis_torch.parallel import trials
        from flexynesis_torch.train import finetune

        self.trials, self.finetune = trials, finetune
        self.grid_fit, self.fit_once = trials.vmapped_grid_fit, finetune.FineTuner._fit_once
        self.run = finetune.FineTuner.run_experiments
        self.grids, self.tuners, self.finals = [], [], []
        watch = self

        def grid_fit(*a, **kw):
            watch.grids.append(watch.grid_fit(*a, **kw))
            return watch.grids[-1]

        def fit_once(tuner, lr, freeze, train_idx, val_idx, max_epochs=None):
            start = {n: t.clone() for n, t in tuner.model.module.state_dict().items()}
            out = watch.fit_once(tuner, lr, freeze, train_idx, val_idx, max_epochs)
            if val_idx is None:
                watch.finals.append((freeze, start, out[1]))
            return out

        def run(tuner, *a, **kw):
            watch.tuners.append(tuner)
            return watch.run(tuner, *a, **kw)

        trials.vmapped_grid_fit = grid_fit
        finetune.FineTuner._fit_once = fit_once
        finetune.FineTuner.run_experiments = run
        return self

    def __exit__(self, *exc):
        self.trials.vmapped_grid_fit = self.grid_fit
        self.finetune.FineTuner._fit_once = self.fit_once
        self.finetune.FineTuner.run_experiments = self.run


def check_frozen(freeze, start: dict, fitted: dict, what: str) -> int:
    """Every leaf of a frozen subtree bit-identical after a fit, and some
    trainable leaf moved; returns the number of frozen leaves."""
    from flexynesis_torch.train.finetune import _make_mask_fn

    trainable = _make_mask_fn(freeze)
    params = [n for n in start if not n.endswith(("running_mean", "running_var",
                                                  "num_batches_tracked"))]
    frozen = [n for n in params if not trainable(n.split(".")[0])]
    moved = [n for n in frozen if not torch_equal(start[n], fitted[n])]
    if moved:
        fail(f"{what}: frozen leaves changed in the fit: {moved[:5]}")
    if not any(not torch_equal(start[n], fitted[n]) for n in params if n not in frozen):
        fail(f"{what}: no trainable leaf moved in the fit")
    return len(frozen)


def torch_equal(a, b) -> bool:
    import torch

    return bool(torch.equal(a.cpu(), b.cpu()))


def finetune_launches(watch: FineTuneWatch, k: int = -1):
    """(B1, B2) launches of the ``k``-th fine-tuning of ``watch``: one per
    block of every grid step for all 45 trials, and of every grid
    validation; one per block of every step of the final fit."""
    out = watch.grids[k]
    tuner = watch.tuners[k]
    final_epochs = tuner.final_choice[2]
    grid_steps = out["epochs_run"] * ((FT_SAMPLES - FT_VAL) // FT_BATCH)
    final_steps = final_epochs * (FT_SAMPLES // FT_BATCH)
    return FT_BLOCKS * (grid_steps + final_steps), FT_BLOCKS * out["epochs_run"], grid_steps


def check_grid_steps(out: Path, cohort):
    """Three stacked steps of the 45-trial fine-tuning grid (f32 parameters
    and bfloat16 moments, the masks of the three freeze configurations, x per
    trial from the folds, dropout 0) from the fine-tuned model saved in
    ``out``, on the card and on the CPU: losses rtol 1e-4, states rtol/atol
    1e-4 (the shift-only entries within their bound); frozen leaves unchanged
    on the card. Returns the card's median step time in ms (synchronised)."""
    import numpy as np
    import torch
    from flexynesis_torch.inference import reconstruct_model
    from flexynesis_torch.parallel.stacked import stacked_model
    from flexynesis_torch.parallel.trials import _Round, _gather, equal_kfold_indices
    from flexynesis_torch.train.finetune import FREEZE_CONFIGS, trial_masks

    saved = [str(out / f"fit.{name}") for name in ("final_model.safetensors",
                                                    "final_model_config.json", "artifacts.json")]
    lr0 = float(reconstruct_model(*saved, device="cpu").config["lr"])
    lrs = np.repeat([lr0 * f for f in (1, 0.1, 0.01) for _ in FREEZE_CONFIGS], FT_FOLDS)
    freezes = [f for _ in range(3) for f in FREEZE_CONFIGS for _ in range(FT_FOLDS)]
    rows = np.random.default_rng(42).choice(len(cohort), FT_SAMPLES, replace=False)
    ft = cohort.subset(rows)
    fold_train, _ = equal_kfold_indices(FT_SAMPLES, FT_FOLDS, seed=42)
    tiled = np.tile(fold_train, (FT_CELLS, 1))  # (45, 80): each trial its fold's rows
    n_tr = tiled.shape[1]
    table = np.stack([tiled[:, a:a + FT_BATCH] for a in (0, FT_BATCH, n_tr - FT_BATCH)], 1)
    runs = {}
    for device in (DEVICE, "cpu"):
        m = _no_dropout(reconstruct_model(*saved, device=device))
        state = {n: t.detach().cpu().clone() for n, t in m.module.state_dict().items()}
        stacked = stacked_model(m, FT_K)
        params, buffers = stacked.stack([{n: t.to(device) for n, t in state.items()}] * FT_K)
        r = _Round(m, params, buffers, lrs=lrs, seeds=np.arange(42, 42 + FT_K),
                   masks=trial_masks(stacked, freezes, device), param_dtype="float32",
                   moment_dtype="bfloat16")
        data = m.make_batch(ft)
        steps = [torch.from_numpy(np.ascontiguousarray(table[:, s])).to(device)
                 for s in range(3)]
        losses = torch.stack([r.step(_gather(data, idx)).cpu() for idx in steps])
        runs[device] = (losses, [stacked.trial_state(r.params, r.buffers, k)
                                 for k in range(FT_K)], r, data, steps)
    (card_losses, card_states, r, data, steps), (cpu_losses, cpu_states, *_) = \
        runs[DEVICE], runs["cpu"]
    if not torch.allclose(card_losses, cpu_losses, rtol=1e-4, atol=0):
        fail(f"finetune: grid steps on the card {card_losses.tolist()} differ from the CPU's "
             f"{cpu_losses.tolist()} (rtol 1e-4)")
    err, share = map(max, zip(*(
        _state_err(card_states[k], cpu_states[k], float(lrs[k]), 3,
                   f"finetune grid trial {k} card against cpu") for k in range(FT_K))))
    frozen = sum(check_frozen(freezes[k], state, card_states[k], f"finetune grid trial {k}")
                 for k in range(FT_K) if freezes[k] != FREEZE_CONFIGS[2])
    times = []
    for i in range(33):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r.step(_gather(data, steps[i % 3]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    step_ms = statistics.median(times[3:]) * 1e3
    print(f"finetune: 3 grid steps of K={FT_K} (x per trial, f32 parameters, bf16 moments) "
          f"card vs cpu: losses max rel diff "
          f"{float(((card_losses - cpu_losses) / cpu_losses).abs().max()):.3e}, states max abs "
          f"diff {err:.3e} (rtol/atol 1e-4; shift-only entries at most {share:.3f} of their "
          f"bounds); {frozen} frozen leaves unchanged over the trials; grid step on the card "
          f"median of 30: {step_ms:.3f} ms", flush=True)
    return step_ms


def hpo_checkpoint_resume(workdir: Path) -> dict:
    """``--hpo_checkpoint`` through the training CLI in subprocesses, a
    same-architecture round of TRIALS suggestions on phase 5's folder: one
    run killed (SIGTERM) once the round's checkpoint appears, its rerun, and
    an uninterrupted run. The rerun must print the resume line, and the GP
    must be told the same TRIALS losses (each trial's best validation loss),
    bit for bit, as in the uninterrupted run. Returns the seconds of each."""
    import glob
    import os
    import signal
    import subprocess

    config = workdir / "ckpt_hpo.yaml"
    config.write_text(TRIAL_CONFIG % (LATENT, HIDDEN_FACTOR, SUP_HIDDEN, FIT_EPOCHS, BATCH))
    env = dict(os.environ, PYTHONPATH=str(REPO))

    def command(name):
        args = train_args(workdir / "fit_data", config, workdir / f"{name}_out", DEVICE)
        args[args.index("--hpo_iter") + 1] = str(TRIALS)
        state = workdir / f"{name}.json"
        return [sys.executable, "-m", "flexynesis_torch", *args, "--hpo_batch", str(TRIALS),
                "--hpo_checkpoint", str(state)], state

    seconds = {}
    cmd, state = command("ckpt_killed")
    t = time.perf_counter()
    with open(workdir / "ckpt_killed.log", "w") as log:
        proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT)
        try:
            pattern = f"{state}.round-*/round.safetensors"
            while proc.poll() is None and not glob.glob(pattern):
                time.sleep(0.02)
            if proc.poll() is not None:
                fail("hpo_checkpoint: the run ended before its round saved a checkpoint; see "
                     f"{workdir / 'ckpt_killed.log'}")
            proc.send_signal(signal.SIGTERM)
            proc.wait(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    seconds["killed"] = time.perf_counter() - t
    if state.exists() or not glob.glob(pattern):
        fail("hpo_checkpoint: the killed run should leave the round checkpoint and no tell")
    runs = {}
    for name, cmd_state in (("resumed", (cmd, state)), ("uninterrupted",
                                                        command("ckpt_uninterrupted"))):
        t = time.perf_counter()
        done = subprocess.run(cmd_state[0], cwd=REPO, env=env, capture_output=True, text=True,
                              timeout=600)
        seconds[name] = time.perf_counter() - t
        (workdir / f"ckpt_{name}.log").write_text(done.stdout + done.stderr)
        if done.returncode != 0:
            fail(f"hpo_checkpoint: the {name} run returned {done.returncode}: "
                 f"{done.stderr[-2000:]}")
        runs[name] = (done.stdout, json.loads(cmd_state[1].read_text()))
    resumed_log, resumed = runs["resumed"]
    line = f"Resumed trial round from epoch {CKPT_EPOCH}"
    if line not in resumed_log:
        fail(f"hpo_checkpoint: the rerun did not print '{line}'")
    if glob.glob(pattern):
        fail("hpo_checkpoint: the finished round left its checkpoint behind")
    got, want = resumed["optimizer"]["y"], runs["uninterrupted"][1]["optimizer"]["y"]
    if len(got) != TRIALS or got != want:
        fail(f"hpo_checkpoint: the resumed round's losses {got} differ from the "
             f"uninterrupted run's {want}")
    print(f"hpo_checkpoint: killed after the epoch-{CKPT_EPOCH} round checkpoint, rerun "
          f"printed '{line}'; its {TRIALS} best validation losses equal the uninterrupted "
          f"run's bit for bit (best {min(got)!r}); seconds "
          + json.dumps({k: round(v, 2) for k, v in seconds.items()}), flush=True)
    return seconds


def finetune_phase(workdir: Path, importer_cache: "ImportOnce"):
    """Phase 11 on phase 5's folder: a fused DirectPred trained with
    ``--covariates age --fusion_type early --finetuning_samples 100`` through
    the training CLI (B1 and B2 launches counted: per block and step, not per
    trial; frozen leaves of the final fit bit-identical, and of fits with each
    freeze configuration), served alike on the card and the CPU; the same
    fine-tuning in inference mode; three grid steps card against CPU; the
    killed and resumed ``--hpo_checkpoint`` round. Returns the launches and
    the summary."""
    import numpy as np
    import torch
    from flexynesis_torch.__main__ import main as cli, parse_args, run_training
    from flexynesis_torch.data.inference_importer import DataImporterInference
    from flexynesis_torch.kernels.fused_linear import (
        fused_linear_bn_relu as b1,
        fused_linear_bn_relu_eval as b2,
    )
    from flexynesis_torch.kernels.mmd import gaussian_kernel_mean as b3
    from flexynesis_torch.train.finetune import FREEZE_CONFIGS

    data = workdir / "fit_data"
    config = workdir / "ft_hpo.yaml"
    config.write_text(HPO_CONFIG % ("DirectPred", LATENT, HIDDEN_FACTOR, SUP_HIDDEN,
                                    FIT_EPOCHS, BATCH))
    out = workdir / "ft_out"
    torch.cuda.reset_peak_memory_stats()
    b1.launches = b2.launches = b3.launches = 0
    with importer_cache, FineTuneWatch() as watch:
        model = run_training(*parse_args([*train_args(data, config, out, DEVICE), *FT_ARGS]))
    launches = (b1.launches, b2.launches, b3.launches)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    if model.layers != ["all"] or model.input_dims != [FUSED_F]:
        fail(f"finetune: early fusion gave layers {model.layers} of {model.input_dims}")
    if model.module.encoder_all.layer_1_kernel.shape[1] != FUSED_H:
        fail("finetune: the early-fusion encoder's hidden width is not "
             f"{FUSED_H}")
    res = model.train_result
    n_fit = FIT_TRAIN - int(math.ceil(FIT_TRAIN * VAL_SIZE))
    ft_b1, ft_b2, grid_steps = finetune_launches(watch)
    want = (FT_BLOCKS * res.epochs_run * (n_fit // BATCH) + ft_b1,
            FT_BLOCKS * (res.epochs_run + EVAL_FORWARDS) + ft_b2, 0)
    if launches != want:
        fail(f"finetune: training launches (B1, B2) = {launches}, expected {want}: "
             f"{FT_BLOCKS} per step and validation, the grid's {FT_K} trials in one")
    lr, freeze, final_epochs = watch.tuners[-1].final_choice
    freeze_name = FREEZE_CONFIGS.index(freeze)
    final_frozen = check_frozen(freeze, *watch.finals[-1][1:], "finetune: the final fit") \
        if freeze != FREEZE_CONFIGS[2] else 0
    tuner = watch.tuners[-1]
    frozen_fits = []
    for cfg in FREEZE_CONFIGS[:2]:  # each freeze configuration freezes for real
        start = {n: t.clone() for n, t in model.module.state_dict().items()}
        _, fitted, _ = tuner._fit_once(lr, cfg, np.arange(FT_SAMPLES), None, max_epochs=2)
        frozen_fits.append(check_frozen(cfg, start, fitted, f"finetune: a fit with freeze {cfg}"))
    print(f"finetune: training CLI with {' '.join(FT_ARGS)} on {DEVICE}: the grid ran "
          f"{watch.grids[-1]['epochs_run']} epochs ({grid_steps} stacked steps of {FT_K} "
          f"trials); chose lr {lr:.3g}, freeze config {freeze_name} {freeze}, {final_epochs} "
          f"final epochs ({final_frozen} frozen leaves bit-identical after the final fit; "
          f"{frozen_fits} after 2-epoch fits with freeze configs 0 and 1); "
          f"launches B1 {launches[0]}, B2 {launches[1]}, B3 {launches[2]} (as expected: "
          f"{FT_BLOCKS} per step and validation, one for all {FT_K} trials); CLI phases "
          "(host clock, s): "
          + json.dumps({k: round(v, 4) for k, v in model.cli_phases.items()})
          + f"; peak allocated on the card {peak_gib:.3f} GiB", flush=True)

    # the fine-tuned model serves alike on the card and on the CPU
    art = out / "fit.artifacts.json"
    classes = len(json.loads(art.read_text())["label_encoders"]["subtype"]["categories"][0])
    for device in (DEVICE, "cpu"):
        if cli(["--pretrained_model", str(out / "fit.final_model.safetensors"),
                "--artifacts", str(art), "--data_path_test", str(data / "test"),
                "--outdir", str(workdir / f"ft_served_{device}"), "--prefix", "smoke",
                "--disable_marker_finding", "--device", device]) != 0:
            fail(f"finetune: serving the fine-tuned model on {device} returned nonzero")
    compare_outputs(workdir / f"ft_served_{DEVICE}", workdir / "ft_served_cpu", FIT_TEST,
                    classes, "finetune: the fine-tuned model served")

    # inference mode: fine-tune the saved model on test samples, then serve it
    b1.launches = b2.launches = b3.launches = 0
    t = time.perf_counter()
    with FineTuneWatch() as infer_watch:
        if cli(["--pretrained_model", str(out / "fit.final_model.safetensors"),
                "--artifacts", str(art), "--data_path_test", str(data / "test"),
                "--outdir", str(workdir / "ft_infer"), "--prefix", "smoke",
                "--disable_marker_finding", "--device", DEVICE,
                "--finetuning_samples", str(FT_SAMPLES)]) != 0:
            fail("finetune: inference mode with --finetuning_samples returned nonzero")
    infer_s = time.perf_counter() - t
    infer_launches = (b1.launches, b2.launches, b3.launches)
    i_b1, i_b2, _ = finetune_launches(infer_watch)
    if infer_launches != (i_b1, i_b2 + FT_BLOCKS * 2, 0):  # transform and predict first
        fail(f"finetune: inference-mode launches {infer_launches}, expected "
             f"{(i_b1, i_b2 + FT_BLOCKS * 2, 0)}")
    weights = workdir / "ft_infer" / "smoke.final_model.safetensors"
    for device in (DEVICE, "cpu"):
        if cli(["--pretrained_model", str(weights), "--artifacts", str(art),
                "--data_path_test", str(data / "test"),
                "--outdir", str(workdir / f"ft_infer_served_{device}"), "--prefix", "smoke",
                "--disable_marker_finding", "--device", device]) != 0:
            fail(f"finetune: serving the inference-mode fine-tuned model on {device} failed")
    compare_outputs(workdir / f"ft_infer_served_{DEVICE}", workdir / "ft_infer_served_cpu",
                    FIT_TEST, classes, "finetune: the inference-mode fine-tuned model served")
    print(f"finetune: inference mode with --finetuning_samples {FT_SAMPLES}: {infer_s:.2f} s, "
          f"launches B1 {infer_launches[0]}, B2 {infer_launches[1]}, B3 {infer_launches[2]}",
          flush=True)

    cohort = DataImporterInference(str(data / "test"), str(art), verbose=False).import_data()
    step_ms = check_grid_steps(out, cohort)
    ckpt_s = hpo_checkpoint_resume(workdir)
    summary = {"grid_step_ms": step_ms, "finetuning_s": model.cli_phases["finetuning"],
               "inference_finetuning_cli_s": infer_s, "peak_allocated_gib": peak_gib,
               "grid_epochs": watch.grids[-1]["epochs_run"], "hpo_checkpoint_s": ckpt_s}
    return {"finetune_training": launches, "finetune_inference": infer_launches}, summary


# ---------------------------------------------------------------- phase 12

BASE_TRAIN, BASE_TEST = 300, 100  # the baselines' folder, cut from phase 5's 2000 + 500
BASE_RAW = {"gex": 400, "cnv": 200}  # selected (top 50 percent) to gex 200, cnv 100
BASE_EPOCHS = 5
BASE_FEATURES_MIN = 50  # below the halves of BASE_RAW, so the top 50 percent is kept
# SVM tables card against CPU: both sides run the host's SMO solver on a float64
# kernel matrix. tools/measure_port_baselines.py read the probabilities apart by
# 4.4e-16 so, by 2.2e-8 with a float32 matrix on the card and 2.0e-5 with TF32
# products (NVIDIA H100 80GB HBM3, 700 W); this limit lies between.
BASE_TOL = 1e-10
GB_TOL = 1e-9  # boosted probabilities card against CPU, training and held-out rows
GB_CPU = {"n_estimators": 50, "max_depth": 6, "learning_rate": 0.1}  # the CPU's comparison fit
# one fit per estimator at the headline width, at the grids' middle depth and
# rate; the forests and the boosting cut from 200 trees to 50
MIDDLE = {"RandomForest": {"n_estimators": 50, "max_depth": 20},
          "SVM": {"C": 1, "kernel": "rbf"},
          "XGBoost": {"n_estimators": 50, "max_depth": 6, "learning_rate": 0.1}}


def _launch_counts():
    from flexynesis_torch.kernels.fused_linear import (
        fused_linear_bn_relu as b1,
        fused_linear_bn_relu_eval as b2,
    )
    from flexynesis_torch.kernels.mmd import gaussian_kernel_mean as b3

    return b1, b2, b3


def cli_run(args, what: str):
    """One training CLI run in this process with B1, B2 and B3 counted from
    0; returns (model, launches, host-clock seconds)."""
    import torch
    from flexynesis_torch.__main__ import parse_args, run_training

    kernels = _launch_counts()
    for k in kernels:
        k.launches = 0
    t = time.perf_counter()
    model = run_training(*parse_args(args))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    launches = tuple(k.launches for k in kernels)
    print(f"{what}: CLI {seconds:.3f} s; launches B1 {launches[0]}, B2 {launches[1]}, "
          f"B3 {launches[2]}", flush=True)
    return model, launches, seconds


def _probabilities(out: Path):
    """{(sample, class): probability} of a CLI run's predicted labels."""
    from flexynesis_torch.utils.csvio import read_table

    samples, cols, rows = read_table(str(out / "fit.predicted_labels.csv"))
    c, p = cols.index("class_label"), cols.index("probability")
    return {(s, r[c]): float(r[p]) for s, r in zip(samples, rows) if r[-2] == "test"}


def h5_phase(workdir: Path, csv_launches) -> tuple:
    """Phase 12 (a) and (b): phase 5's folder converted by the port's
    csv_to_h5 and read back against the CSV reader bit for bit; the
    h5py-written fixture against its CSV twin; the phase 5 run on the .h5
    folder (selected features, B1/B2 launches and test probabilities equal
    to the CSV run's, the saved model served alike on the card and the CPU);
    the same run with --profile (JAX's phase names, a Chrome trace naming
    B1 and B2, the profiler's overhead). Returns the launches and summary."""
    import numpy as np
    from flexynesis_torch.csv_to_h5 import convert_csv_to_h5
    from flexynesis_torch.data.fastcsv import read_matrix_csv
    from flexynesis_torch.utils.hdf5 import read_matrix_h5

    data, h5 = workdir / "fit_data", workdir / "h5_data"
    t = time.perf_counter()
    for split in ("train", "test"):
        (h5 / split).mkdir(parents=True, exist_ok=True)
        shutil.copy(data / split / "clin.csv", h5 / split / "clin.csv")
        for layer in ("gex", "cnv"):
            convert_csv_to_h5(data / split / f"{layer}.csv", h5 / split / f"{layer}.h5")
    convert_s = time.perf_counter() - t
    seconds = {"csv": 0.0, "h5": 0.0}
    pairs = [(data / s / f"{x}.csv", h5 / s / f"{x}.h5") for s in ("train", "test")
             for x in ("gex", "cnv")]
    pairs.append((REPO / "tests" / "fixtures" / "h5" / "gex.csv",
                  REPO / "tests" / "fixtures" / "h5" / "gex.h5"))
    for csv, h5_path in pairs:
        t = time.perf_counter()
        a = read_matrix_csv(str(csv))
        t_csv = time.perf_counter() - t
        t = time.perf_counter()
        b = read_matrix_h5(str(h5_path))
        t_h5 = time.perf_counter() - t
        if a[:2] != b[:2] or a[2].shape != b[2].shape or a[2].tobytes() != b[2].tobytes():
            fail(f"h5: {h5_path} does not read as {csv} does, bit for bit")
        if "fixtures" not in str(csv):
            seconds["csv"] += t_csv
            seconds["h5"] += t_h5
        name = f"{h5_path.parent.name}/{h5_path.name}"
        print(f"h5: {name} {b[2].shape[0]} x {b[2].shape[1]} equal to its CSV bit for bit; "
              f"CSV reader {t_csv:.3f} s, HDF5 reader {t_h5:.3f} s", flush=True)
    print(f"h5: converted phase 5's folder in {convert_s:.3f} s; its four matrices read in "
          f"{seconds['csv']:.3f} s (CSV) and {seconds['h5']:.3f} s (HDF5)", flush=True)

    config = workdir / "fit_hpo.yaml"  # phase 5's
    args = train_args(h5, config, workdir / "h5_out", DEVICE)
    model, launches, cli_s = cli_run(args, "h5: the phase 5 run on the .h5 folder")
    if launches[:2] != tuple(csv_launches) or launches[2]:
        fail(f"h5: launches {launches}, the CSV run's were {csv_launches} (B3 0)")
    csv_art = json.loads((workdir / "fit_out" / "fit.artifacts.json").read_text())
    h5_art = json.loads((workdir / "h5_out" / "fit.artifacts.json").read_text())
    if csv_art["feature_lists"] != h5_art["feature_lists"]:
        fail("h5: the .h5 run selected other features than the CSV run")
    a, b = _probabilities(workdir / "fit_out"), _probabilities(workdir / "h5_out")
    if a.keys() != b.keys():
        fail("h5: the .h5 and CSV runs predicted different rows")
    keys = sorted(a)
    pa, pb = np.array([a[k] for k in keys]), np.array([b[k] for k in keys])
    p_err = float(np.abs(pa - pb).max())
    if not np.allclose(pa, pb, **TOL):
        fail(f"h5: test probabilities differ from the CSV run's by {p_err:.3e}")
    for device in (DEVICE, "cpu"):
        from flexynesis_torch.__main__ import main as cli

        if cli(["--pretrained_model", str(workdir / "h5_out" / "fit.final_model.safetensors"),
                "--artifacts", str(workdir / "h5_out" / "fit.artifacts.json"),
                "--data_path_test", str(data / "test"),
                "--outdir", str(workdir / f"h5_served_{device}"),
                "--prefix", "smoke", "--disable_marker_finding", "--device", device]) != 0:
            fail(f"h5: serving the .h5-trained model on {device} returned nonzero")
    classes = len(h5_art["label_encoders"]["subtype"]["categories"][0])
    compare_outputs(workdir / f"h5_served_{DEVICE}", workdir / "h5_served_cpu", FIT_TEST,
                    classes, "h5: the .h5-trained model served")
    widths = ", ".join(f"{k} {len(v)}" for k, v in h5_art["feature_lists"].items())
    print(f"h5: selected features equal the CSV run's ({widths}); "
          f"test probabilities within {p_err:.3e} of the CSV run's; CLI phases (host clock, s): "
          + json.dumps({k: round(v, 4) for k, v in model.cli_phases.items()}), flush=True)

    out = workdir / "prof_out"
    _, prof_launches, prof_s = cli_run(train_args(h5, config, out, DEVICE) + ["--profile"],
                                       "profile: the .h5 run with --profile")
    if prof_launches != launches:
        fail(f"profile: launches {prof_launches}, without --profile {launches}")
    phases = json.loads((out / "fit.profile.json").read_text())
    want = ["data_import", "hpo_training", "evaluation_outputs"]
    if list(phases) != want or any(set(p) != {"seconds", "device_bytes_delta"}
                                   for p in phases.values()):
        fail(f"profile: fit.profile.json holds {phases}, expected the phases {want}")
    trace = (out / "fit.profile" / "trace.json").read_text()
    named = {n: trace.count(n) for n in (KERNEL_FUNCTIONS[0], KERNEL_FUNCTIONS[2])}
    if not all(named.values()):
        fail(f"profile: the trace does not name B1 and B2: {named}")
    print(f"profile: phases {json.dumps(phases)}; the trace ({len(trace) / 2 ** 20:.1f} MiB) "
          f"names {json.dumps(named)}; CLI {prof_s:.3f} s against {cli_s:.3f} s without "
          f"--profile (overhead {prof_s - cli_s:+.3f} s, {100 * (prof_s / cli_s - 1):+.1f}%)",
          flush=True)
    summary = {"convert_s": convert_s, "csv_read_s": seconds["csv"], "h5_read_s": seconds["h5"],
               "h5_cli_s": cli_s, "h5_cli_phases": model.cli_phases, "profile_cli_s": prof_s,
               "profile_phases": phases, "h5_vs_csv_probability_err": p_err}
    return {"h5_training": launches, "h5_profile": prof_launches}, summary


def phase5_training_set(importer_cache: "ImportOnce", workdir: Path, what: str):
    """Phase 5's imported training set (2000 samples, gex 2000 + cnv 1000),
    as its import cached it."""
    for key, (_, (train, _)) in importer_cache.done.items():
        if key[0] == str(workdir / "fit_data") and key[2] is None and key[4] == "intermediate":
            return train
    fail(f"{what}: phase 5's import is not in the cache")


def _headline_xy(importer_cache: "ImportOnce", workdir: Path, kind: str):
    """Phase 5's imported training set (2000 x 3000): its first KFold fold's
    training rows (1600, the rows one grid fit takes) with a label, and the
    labels (subtype codes, or age)."""
    import numpy as np
    from flexynesis_torch.utils.classical import KFold

    train = phase5_training_set(importer_cache, workdir, "baselines")
    X = np.concatenate(list(train.dat.values()), axis=1)
    rows = next(KFold(5, shuffle=True, random_state=42).split(X))[0]
    y = np.asarray(train.ann["subtype" if kind == "categorical" else "age"],
                   dtype=np.float64)[rows]
    ok = np.isfinite(y) & (y != -1)
    return X[rows][ok], (y[ok].astype(int) if kind == "categorical" else y[ok])


def baseline_phase(workdir: Path, importer_cache: "ImportOnce") -> tuple:
    """Phase 12 (c): on a reduced folder (cuts printed), a fused DirectPred
    with and without --evaluate_baseline_performance (B1/B2 launches equal),
    --model_class SVM, XGBoost and RandomSurvivalForest timed, the SVM grid's
    tables and a GradientBoosting fit on the card against the CPU; then one
    fit of each estimator at its grid's middle point at the headline width.
    Returns the launches and the summary."""
    import numpy as np
    import torch
    from flexynesis_torch.data.importer import DataImporter
    from flexynesis_torch.utils import baselines
    from flexynesis_torch.utils.csvio import read_table
    from flexynesis_torch.utils.synthetic import write_synthetic_folder

    data = workdir / "base_data"
    write_synthetic_folder(str(data), n_train=BASE_TRAIN, n_test=BASE_TEST,
                           n_features=BASE_RAW, n_classes=N_CLASSES, seed=2)
    print(f"baselines: reduced folder (cut from phase 5's {FIT_TRAIN} + {FIT_TEST} samples of "
          f"{RAW_GEX} + {RAW_CNV} features): {BASE_TRAIN} train + {BASE_TEST} test samples, "
          f"raw gex {BASE_RAW['gex']} and cnv {BASE_RAW['cnv']} selected to "
          f"{BASE_RAW['gex'] // 2} and {BASE_RAW['cnv'] // 2}; 4-class subtype, age, "
          "OS_MONTHS/OS_STATUS; the deep model runs 5 epochs", flush=True)
    config = workdir / "base_hpo.yaml"
    config.write_text(HPO_CONFIG % ("DirectPred", LATENT, HIDDEN_FACTOR, SUP_HIDDEN,
                                    BASE_EPOCHS, BATCH))
    surv = ["--surv_event_var", "OS_STATUS", "--surv_time_var", "OS_MONTHS"]
    runs, seconds = {}, {}

    def base_args(out: Path, model_class: str = "DirectPred", extra=()):
        args = train_args(data, config, out, DEVICE, model_class=model_class, extra=extra)
        args[args.index("--features_min") + 1] = str(BASE_FEATURES_MIN)
        return args

    for name, extra in (("directpred", surv), ("directpred_baselines",
                                               surv + ["--evaluate_baseline_performance"])):
        _, runs[name], seconds[name] = cli_run(base_args(workdir / f"{name}_out", extra=extra),
                                               f"baselines: {name}")
    if runs["directpred_baselines"] != runs["directpred"] or not runs["directpred"][0]:
        fail(f"baselines: launches with the flag {runs['directpred_baselines']}, without "
             f"{runs['directpred']}")
    names, _, _ = read_table(str(workdir / "directpred_baselines_out" / "fit.baseline.stats.csv"))
    want = {"RandomForestClassifier", "SVMClassifier", "XGBoostClassifier", "RandomSurvivalForest"}
    if set(names) != want:
        fail(f"baselines: fit.baseline.stats.csv holds {sorted(set(names))}")
    names, _, rows = read_table(str(workdir / "directpred_baselines_out"
                                    / "fit.baseline.stats.csv"))
    for n, r in zip(names, rows):
        print(f"baselines: baseline stats {n},{','.join(r)}", flush=True)

    for mc in ("SVM", "XGBoost", "RandomSurvivalForest"):
        extra = surv if mc == "RandomSurvivalForest" else []
        _, runs[mc], seconds[mc] = cli_run(base_args(workdir / f"{mc}_out", mc, extra),
                                           f"baselines: --model_class {mc}")
        if runs[mc] != (0, 0, 0):
            fail(f"baselines: --model_class {mc} launched the kernels {runs[mc]}")
        names, _, rows = read_table(str(workdir / f"{mc}_out" / "fit.stats.csv"))
        for n, r in zip(names, rows):
            print(f"baselines: {mc} stats {n},{','.join(r)}", flush=True)

    # the card's SVM grid and a boosting fit against the CPU
    train, test = DataImporter(str(data), ["gex", "cnv"], top_percentile=TOP_PERCENTILE,
                               min_features=BASE_FEATURES_MIN, variance_threshold=0.0,
                               device=DEVICE).import_data()
    widths = {k: v.shape[1] for k, v in train.dat.items()}
    if widths != {k: v // 2 for k, v in BASE_RAW.items()}:
        fail(f"baselines: selected widths {widths}")
    tables = {}
    for device in (DEVICE, "cpu"):
        t = time.perf_counter()
        tables[device] = baselines.evaluate_baseline_performance(
            train, test, "subtype", ["SVM"], device=device)
        seconds[f"svm_grid_{device}"] = time.perf_counter() - t
    (s_gpu, p_gpu), (s_cpu, p_cpu) = tables[DEVICE], tables["cpu"]
    m_err = max(abs(a["value"] - b["value"]) for a, b in zip(s_gpu, s_cpu)
                if a["value"] is not None or b["value"] is not None)
    pr_err = max(abs(a["probability"] - b["probability"]) for a, b in zip(p_gpu, p_cpu))
    if m_err > BASE_TOL or pr_err > BASE_TOL:
        fail(f"baselines: the SVM tables differ card against CPU: metrics {m_err:.3e}, "
             f"probabilities {pr_err:.3e} (tol {BASE_TOL})")
    X, y, _ = baselines._prepare_xy(train, "subtype")
    Xt = baselines._prepare_xy(test, "subtype")[0]
    y = y.astype(int)
    fits = {}
    for device in (DEVICE, "cpu"):
        est, _ = baselines._grids("XGBoost", "categorical", device)
        t = time.perf_counter()
        gb = est.clone(**GB_CPU).fit(X, y)
        fits[device] = (gb.predict_proba(X), gb.predict_proba(Xt))
        seconds[f"gb_fit_{device}"] = time.perf_counter() - t
    gb_train = float(np.abs(fits[DEVICE][0] - fits["cpu"][0]).max())
    gb_test = float(np.abs(fits[DEVICE][1] - fits["cpu"][1]).max())
    if max(gb_train, gb_test) > GB_TOL:
        fail(f"baselines: GradientBoosting probabilities differ card against CPU by "
             f"{gb_train:.3e} (training rows), {gb_test:.3e} (held-out rows) (tol {GB_TOL})")
    print(f"baselines: card against CPU: SVM grid tables metrics {m_err:.3e}, probabilities "
          f"{pr_err:.3e} (tol {BASE_TOL}; {seconds[f'svm_grid_{DEVICE}']:.2f} s card, "
          f"{seconds['svm_grid_cpu']:.2f} s cpu); GradientBoosting {GB_CPU}: "
          f"training rows {gb_train:.3e}, held-out rows {gb_test:.3e} (tol {GB_TOL}; "
          f"{seconds[f'gb_fit_{DEVICE}']:.2f} s card, {seconds['gb_fit_cpu']:.2f} s cpu)",
          flush=True)

    # one fit at each grid's middle point at the headline width
    headline = {}
    for kind in ("categorical", "numerical"):
        X, y = _headline_xy(importer_cache, workdir, kind)
        for method, params in MIDDLE.items():
            est, _ = baselines._grids(method, kind, DEVICE)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            est.clone(**params).fit(X, y)
            torch.cuda.synchronize()
            headline[f"{method}_{kind}"] = time.perf_counter() - t
            print(f"baselines: headline width {X.shape[0]} x {X.shape[1]}: {type(est).__name__}"
                  f"({params}) fit {headline[f'{method}_{kind}']:.3f} s, peak allocated "
                  f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB", flush=True)
    rsf = baselines.RandomForestRegressor(n_estimators=100, max_depth=5, min_samples_split=10,
                                          min_samples_leaf=15, max_features="sqrt",
                                          random_state=42, device=DEVICE)
    t = time.perf_counter()
    rsf.fit(X, y)
    torch.cuda.synchronize()
    headline["RandomSurvivalForest"] = time.perf_counter() - t
    print(f"baselines: headline width: the survival forest fit "
          f"{headline['RandomSurvivalForest']:.3f} s", flush=True)
    summary = {"cli_s": seconds, "headline_fit_s": headline, "svm_card_cpu_err": [m_err, pr_err],
               "gb_card_cpu_err": [gb_train, gb_test]}
    return {f"baselines_{k}": v for k, v in runs.items()}, summary


# ------------------------------------------- phase 13: the analysis surface

# co-expression at a cohort's width: planted modules of genes driven by one
# shared factor each (|r| about 0.6-0.9 within a module), the other genes
# independent
COEXP_GENES, COEXP_SAMPLES, COEXP_MODULES, COEXP_MODULE_SIZE = 20000, 1000, 400, 25
COEXP_THRESHOLD, COEXP_TOP_K = 0.5, 5
COEXP_CHECK_GENES = 4000  # Poisson counts (ties), card against CPU
COEXP_MAX_GENES = 12000  # the CLI's --max_genes on the cohort's file
COEXP_TOL = 1e-5  # scores: float32 Gram products in two summation orders
EDGE_BAND = 1e-6  # pairs this close to the threshold may part between devices
GNN_COEXP_THRESHOLD, GNN_COEXP_EPOCHS = 0.3, 2  # the GNN tutorial's network, 2 epochs
SURV_EPOCHS = 5  # the survival DirectPred, cut to 5 epochs
SURV_MARKERS = 5  # the Cox model's covariates: the top markers of the survival target
COX_RTOL = 1e-8  # float64 Newton on both devices
CLUSTER_TOL = 1e-8  # float64 silhouettes
SINKHORN_RTOL, ALIGN_TOL = 1e-5, 1e-4  # float32 Sinkhorn; the barycentric projection


def write_fixed_csv(path: Path, rows, columns, X, decimals: int = 3) -> None:
    """A rows x columns CSV of X rounded to ``decimals``, each cell of fixed
    width (sign or 0, two integer digits, the decimals), formatted by numpy:
    seconds for 20 million cells where a Python loop takes minutes. |X| < 100."""
    import numpy as np

    q = np.rint(np.abs(X) * 10 ** decimals).astype(np.int64)
    width = 4 + decimals  # sign, two digits, the point, the decimals, the comma
    cells = np.empty(q.shape + (width,), dtype=np.uint8)
    cells[..., 0] = np.where(X < 0, ord("-"), ord("0"))
    cells[..., 1] = 48 + q // 10 ** (decimals + 1) % 10
    cells[..., 2] = 48 + q // 10 ** decimals % 10
    cells[..., 3] = ord(".")
    for d in range(decimals):
        cells[..., 4 + d] = 48 + q // 10 ** (decimals - 1 - d) % 10
    cells[..., -1] = ord(",")
    cells[:, -1, -1] = ord("\n")
    with open(path, "wb") as fh:
        fh.write(("," + ",".join(columns) + "\n").encode())
        for name, row in zip(rows, cells.reshape(len(rows), -1)):
            fh.write(name.encode() + b",")
            fh.write(row.tobytes())


def planted_expression(seed: int, genes: int, samples: int, modules: int, size: int):
    """log2-expression-like values (8 + 1.5 x), x = a shared factor times a
    loading of 0.8-1.6 and random sign plus noise of sd 0.5 for the genes of
    each module (the first modules x size genes), standard normal for the
    rest; to three decimals."""
    import numpy as np

    rng = np.random.default_rng(seed)
    X = rng.normal(size=(genes, samples))
    n_mod = modules * size
    factors = rng.normal(size=(modules, samples))
    load = rng.uniform(0.8, 1.6, n_mod) * rng.choice([-1.0, 1.0], n_mod)
    X[:n_mod] = load[:, None] * np.repeat(factors, size, axis=0) + 0.5 * X[:n_mod]
    return np.round(np.clip(8 + 1.5 * X, 0, 99.999), 3)


def read_edges(path: Path):
    """(GeneA positions, GeneB positions, scores) of a network file whose
    genes are named g0, g1, ..."""
    import numpy as np

    with open(path) as fh:
        header = fh.readline().strip()
        if header != "GeneA,GeneB,Score":
            fail(f"{path}: header {header!r}")
        rows = [line.rstrip("\n").split(",") for line in fh]
    return (np.array([int(r[0][1:]) for r in rows], dtype=np.int64),
            np.array([int(r[1][1:]) for r in rows], dtype=np.int64),
            np.array([float(r[2]) for r in rows]))


def coexpression_cohort(workdir: Path) -> dict:
    """Phase 13 (a): the co-expression CLI over COEXP_GENES x COEXP_SAMPLES
    with planted modules, Spearman then Pearson: every planted pair found
    (the seconds of each part, peak allocated memory, edge count); then the
    sweep at COEXP_CHECK_GENES genes of Poisson counts on the card against
    the CPU for both methods."""
    import numpy as np
    import torch
    from flexynesis_torch import coexpression

    t = time.perf_counter()
    X = planted_expression(13, COEXP_GENES, COEXP_SAMPLES, COEXP_MODULES, COEXP_MODULE_SIZE)
    genes = [f"g{i}" for i in range(COEXP_GENES)]
    path = workdir / "coexp_input.csv"
    write_fixed_csv(path, genes, [f"S{j:04d}" for j in range(COEXP_SAMPLES)], X)
    print(f"analysis: wrote {COEXP_GENES} genes x {COEXP_SAMPLES} samples "
          f"({path.stat().st_size / 2 ** 20:.1f} MiB; {COEXP_MODULES} modules of "
          f"{COEXP_MODULE_SIZE}) in {time.perf_counter() - t:.2f} s", flush=True)
    n_mod = COEXP_MODULES * COEXP_MODULE_SIZE
    planted = {(a, b) for m in range(COEXP_MODULES) for a in range(m * COEXP_MODULE_SIZE,
                                                                   (m + 1) * COEXP_MODULE_SIZE)
               for b in range(a + 1, (m + 1) * COEXP_MODULE_SIZE)}
    flops = 2.0 * COEXP_GENES ** 2 * COEXP_SAMPLES
    summary = {"genes": COEXP_GENES, "samples": COEXP_SAMPLES, "planted_edges": len(planted),
               "gram_flops": flops, "gram_bound_ms": f32_ms(flops)}
    for method in ("spearman", "pearson"):
        out = workdir / f"coexp_{method}.csv"
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        timings = coexpression.main(["--input", str(path), "--output", str(out), "--method",
                                     method, "--correlation_threshold", str(COEXP_THRESHOLD),
                                     "--top_k", str(COEXP_TOP_K), "--device", DEVICE])
        cli_s = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        a, b, score = read_edges(out)
        found = set(zip(a.tolist(), b.tolist()))
        missing = planted - found
        if missing:
            fail(f"analysis: {method} network misses {len(missing)} of {len(planted)} planted "
                 f"edges, e.g. {sorted(missing)[:3]}")
        if not (np.abs(score) >= COEXP_THRESHOLD).all() or not (a < b).all():
            fail(f"analysis: {method} network holds a pair below the threshold or unordered")
        within = np.abs(score[(a < n_mod) & (b < n_mod) & (a // COEXP_MODULE_SIZE
                                                          == b // COEXP_MODULE_SIZE)])
        full = dict(zip(zip(a.tolist(), b.tolist()), score.tolist()))
        summary[method] = {"cli_s": cli_s, "seconds": timings, "edges": len(score),
                           "extra_edges": len(found - planted), "peak_gib": peak,
                           "within_module_abs_r": [float(within.min()), float(within.max())]}
        print(f"analysis: coexpression CLI ({method}) on {DEVICE} {cli_s:.3f} s: "
              + ", ".join(f"{k} {v:.3f} s" for k, v in timings.items())
              + f"; {len(score)} edges, every planted edge found, {len(found - planted)} "
              f"others; |r| within modules [{within.min():.3f}, {within.max():.3f}]; peak "
              f"allocated {peak:.3f} GiB; Gram bound {f32_ms(flops):.2f} ms (f32, "
              f"{flops:.3g} FLOP)", flush=True)
    summary["max_genes"] = coexpression_max_genes(workdir, path, X, full)

    rng = np.random.default_rng(14)
    Z = planted_expression(15, COEXP_CHECK_GENES, COEXP_SAMPLES, COEXP_CHECK_GENES // 50,
                           COEXP_MODULE_SIZE)
    counts = rng.poisson(np.exp((Z - 8) / 3 + 1.0)).astype(np.float64)
    small = [f"g{i}" for i in range(COEXP_CHECK_GENES)]
    for method in ("spearman", "pearson"):
        nets = {}
        for device in (DEVICE, "cpu"):
            t = time.perf_counter()
            nets[device], _ = coexpression.build_network(
                small, counts, method=method, correlation_threshold=COEXP_THRESHOLD,
                top_k=COEXP_TOP_K, device=device)
            print(f"analysis: {COEXP_CHECK_GENES}-gene {method} sweep of Poisson counts on "
                  f"{device} {time.perf_counter() - t:.3f} s", flush=True)
        g = dict(zip(zip(nets[DEVICE]["GeneA"], nets[DEVICE]["GeneB"]), nets[DEVICE]["Score"]))
        c = dict(zip(zip(nets["cpu"]["GeneA"], nets["cpu"]["GeneB"]), nets["cpu"]["Score"]))
        differ = set(g) ^ set(c)
        band = [k for k in differ if abs(abs(g.get(k, c.get(k))) - COEXP_THRESHOLD) < EDGE_BAND]
        if len(band) != len(differ):
            fail(f"analysis: {method} edge sets differ card against cpu away from the "
                 f"threshold: {sorted(set(differ) - set(band))[:3]}")
        common = sorted(set(g) & set(c))
        err = max(abs(g[k] - c[k]) for k in common) if common else 0.0
        if not common or err > COEXP_TOL:
            fail(f"analysis: {method} scores card against cpu: {len(common)} common edges, "
                 f"max abs diff {err:.3e} (tol {COEXP_TOL})")
        summary[f"check_{method}"] = {"edges": len(common), "max_abs_err": err,
                                      "near_threshold_differ": len(band)}
        print(f"analysis: {method} card against cpu: {len(common)} edges equal, "
              f"{len(band)} within {EDGE_BAND} of the threshold differ; scores max abs diff "
              f"{err:.3e} (tol {COEXP_TOL})", flush=True)
    return summary


def coexpression_max_genes(workdir: Path, path: Path, X, full: dict) -> dict:
    """The co-expression CLI with ``--max_genes COEXP_MAX_GENES`` (Pearson)
    on the cohort's file: its genes are the most variable ones (float64
    sample variance of the written values; genes within 1e-6 relative of the
    cut may fall either way, as the reader parses float32), and its edges are
    the full Pearson network's among them (``full``: (a, b) -> score)."""
    import numpy as np
    import torch
    from flexynesis_torch import coexpression

    out = workdir / "coexp_max_genes.csv"
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    timings = coexpression.main(["--input", str(path), "--output", str(out), "--method",
                                 "pearson", "--correlation_threshold", str(COEXP_THRESHOLD),
                                 "--top_k", str(COEXP_TOP_K), "--max_genes",
                                 str(COEXP_MAX_GENES), "--device", DEVICE])
    cli_s = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    var = X.var(axis=1, ddof=1)
    cut = np.sort(var)[-COEXP_MAX_GENES]
    near = np.abs(var - cut) <= 1e-6 * cut
    top, sure = var >= cut, (var >= cut) & ~near
    a, b, score = read_edges(out)  # in the kept genes' order: each pair as (low, high)
    got = dict(zip(zip(np.minimum(a, b).tolist(), np.maximum(a, b).tolist()), score.tolist()))
    outside = [k for k in got if not (top | near)[list(k)].all()]
    if outside:
        fail(f"analysis: --max_genes {COEXP_MAX_GENES} network holds {len(outside)} edges of "
             f"genes below the variance cut, e.g. {outside[:3]}")
    want = {k for k in full if sure[list(k)].all()}
    missing = [k for k in want - set(got) if abs(abs(full[k]) - COEXP_THRESHOLD) >= EDGE_BAND]
    err = max(abs(got[k] - full[k]) for k in want & set(got))
    if missing or err > COEXP_TOL:
        fail(f"analysis: --max_genes {COEXP_MAX_GENES} network misses {len(missing)} edges of "
             f"the full network among its genes (e.g. {missing[:3]}), or its scores differ "
             f"by {err:.3e} (tol {COEXP_TOL})")
    print(f"analysis: coexpression CLI (pearson, --max_genes {COEXP_MAX_GENES}) on {DEVICE} "
          f"{cli_s:.3f} s: " + ", ".join(f"{k} {v:.3f} s" for k, v in timings.items())
          + f"; {len(got)} edges, the full network's among the kept genes ({int(near.sum())} "
          f"genes at the cut); scores max abs diff {err:.3e}; peak allocated {peak:.3f} GiB",
          flush=True)
    return {"cli_s": cli_s, "seconds": timings, "edges": len(got), "peak_gib": peak,
            "genes_at_cut": int(near.sum()), "max_abs_err": err}


def gnn_on_coexpression(workdir: Path):
    """Phase 13 (b): the GNN tutorial's flow on phase 10's GNN folder: a
    Pearson network (GNN_COEXP_THRESHOLD, top-k 5) of its train/gex.csv by
    the co-expression CLI, then a GNN through the training CLI with
    ``--user_graph`` on it (one trial, GNN_COEXP_EPOCHS epochs). Every gene
    of that folder holds NaN cells (1 percent of cells), and a NaN
    correlation is below any threshold, as in JAX: the raw file gives no
    edge, so the network is built from the file with each gene's NaN cells
    set to its median (the GNN's own node fill)."""
    import numpy as np
    from flexynesis_torch import coexpression
    from flexynesis_torch.data.fastcsv import read_matrix_csv

    data = workdir / "gnn_data"
    raw = data / "train" / "gex.csv"
    args = ["--method", "pearson", "--correlation_threshold", str(GNN_COEXP_THRESHOLD),
            "--top_k", "5", "--device", DEVICE]
    coexpression.main(["--input", str(raw), "--output", str(workdir / "gnn_coexp_raw.csv"), *args])
    ra, rb, _ = read_edges(workdir / "gnn_coexp_raw.csv")
    raw_edges = len(ra)
    genes, samples, X = read_matrix_csv(str(raw))
    has_nan = np.isnan(X).any(axis=1)
    nan_genes = int(has_nan.sum())
    if has_nan[ra].any() or has_nan[rb].any():
        fail("analysis: the raw GNN matrix's network holds an edge of a gene with NaN cells")
    filled = np.where(np.isnan(X), np.nanmedian(X, axis=1, keepdims=True), X)
    inp = workdir / "gnn_coexp_input.csv"
    write_fixed_csv(inp, genes, samples, filled, decimals=4)
    net = workdir / "gnn_coexp_net.csv"
    timings = coexpression.main(["--input", str(inp), "--output", str(net), *args])
    n_edges = sum(1 for _ in open(net)) - 1
    config = workdir / "gnn_coexp_hpo.yaml"
    config.write_text(GNN_CONFIG % (LATENT, GNN_EMBED, GNN_CONVS, LR_FIXED, SUP_HIDDEN,
                                    GNN_COEXP_EPOCHS, BATCH))
    out = workdir / "gnn_coexp_out"
    model, launches, cli_s = cli_run(train_args(data, config, out, DEVICE, "GNN",
                                                ("--user_graph", str(net))), "analysis: GNN")
    zoo_launches("analysis: GNN on the co-expression network", launches)
    missing = [f for f in ("fit.stats.csv", "fit.predicted_labels.csv", "fit.embeddings_test.csv",
                           "fit.final_model.safetensors", "fit.final_model_config.json")
               if not (out / f).exists()]
    if missing:
        fail(f"analysis: the GNN on the co-expression network did not write {missing}")
    node_edges = int(model.nw_dataset.edge_index.shape[1])
    if model.n_nodes < 2 or node_edges == 0:
        fail(f"analysis: GNN over {model.n_nodes} nodes and {node_edges} edges")
    print(f"analysis: raw gex.csv {raw_edges} edges ({nan_genes} of {len(genes)} genes hold NaN); "
          f"median-filled {n_edges} edges (" + ", ".join(f"{k} {v:.3f} s" for k, v in
                                                       timings.items())
          + f"); GNN through the training CLI {cli_s:.3f} s over {model.n_nodes} nodes and "
          f"{node_edges} edges in the node set; launches (B1, B2, B3) {launches}", flush=True)
    return launches, {"network_edges": n_edges, "seconds": timings, "gnn_cli_s": cli_s,
                      "nodes": model.n_nodes, "node_set_edges": node_edges}


def survival_steps(risk, time_, event, cox, device: str) -> dict:
    """The survival tutorial's steps after training: the optimal cut-off of
    the risk and its log-rank test, Kaplan-Meier per group, the Cox model on
    the top markers with its 5-fold CV C-index and the AUC at the median
    time; the Cox fits on ``device``."""
    import numpy as np
    from flexynesis_torch.utils.survival import (
        KaplanMeier,
        build_cox_model,
        find_optimal_cutoff,
        logrank_test,
    )

    cutoff, cutoff_p = find_optimal_cutoff(risk, time_, event)
    if cutoff is None:
        cutoff, cutoff_p = float(np.median(risk)), float("nan")
    hi = risk > cutoff
    lr = logrank_test(time_[hi], time_[~hi], event[hi], event[~hi])
    km = {g: KaplanMeier().fit(time_[m], event[m]) for g, m in (("high", hi), ("low", ~hi))}
    t = time.perf_counter()
    model, metrics = build_cox_model(cox, "OS_MONTHS", "OS_STATUS",
                                     eval_time=float(np.median(time_)), device=device)
    return {"cutoff": cutoff, "cutoff_p": cutoff_p, "logrank": lr.test_statistic,
            "logrank_p": lr.p_value, "km_median": {g: float(k.timeline[np.argmax(k.survival <= 0.5)])
                                                   if (k.survival <= 0.5).any() else None
                                                   for g, k in km.items()},
            "cv_cindex": metrics["cv_cindex"], "cv_cindex_mean": metrics["cv_cindex_mean"],
            "cv_auc_mean": metrics["cv_auc_mean"], "coef": model.params_,
            "se": model.standard_errors_, "features": model.features_,
            "cox_s": time.perf_counter() - t}


def survival_analysis(workdir: Path):
    """Phase 13 (c): an unfused DirectPred with a survival head on phase 5's
    folder (OS_STATUS / OS_MONTHS) at the headline width with marker finding,
    then the tutorial's steps on its test risk on the card and on the CPU:
    the same cut-off, log-rank and Kaplan-Meier, the same fold C-indices,
    Cox coefficients and standard errors within COX_RTOL."""
    import numpy as np
    from flexynesis_torch.data.inference_importer import DataImporterInference
    from flexynesis_torch.utils.csvio import Table
    from flexynesis_torch.utils.survival import build_cox_model

    data = workdir / "fit_data"
    config = workdir / "surv_hpo.yaml"
    config.write_text((HPO_CONFIG % ("DirectPred", LATENT, HIDDEN_FACTOR, SUP_HIDDEN,
                                     SURV_EPOCHS, BATCH)).replace("[true]", "[false]"))
    out = workdir / "surv_out"
    model, launches, cli_s = cli_run(
        train_args(data, config, out, DEVICE, extra=("--surv_event_var", "OS_STATUS",
                                                     "--surv_time_var", "OS_MONTHS"),
                   markers=True), "analysis: survival DirectPred")
    zoo_launches("analysis: the unfused survival DirectPred", launches)
    cohort = DataImporterInference(str(data / "test"), str(out / "fit.artifacts.json"),
                                   verbose=False).import_data()
    risk = np.asarray(model.predict(cohort)["OS_STATUS"], dtype=float).ravel()
    time_ = np.asarray(cohort.ann["OS_MONTHS"], dtype=float)
    event = np.asarray(cohort.ann["OS_STATUS"], dtype=float)
    keep = np.isfinite(time_) & np.isfinite(event) & np.isfinite(risk)
    keys, imp = read_importances(out, "fit")["IntegratedGradients"]
    rows = sorted((k for k in zip(keys, imp) if k[0][0] == "OS_STATUS"), key=lambda r: -r[1])
    top = [(k[3], k[4]) for k, _ in rows[:SURV_MARKERS]]
    cols = [np.asarray(cohort.dat[layer])[:, cohort.features[layer].index(name)]
            for layer, name in top]
    values = np.column_stack([*cols, time_, event])[keep]
    cox = Table([s for s, k in zip(cohort.samples, keep) if k],
                [f"{layer}:{name}" for layer, name in top] + ["OS_MONTHS", "OS_STATUS"], values)
    steps = {d: survival_steps(risk[keep], time_[keep], event[keep], cox, d)
             for d in (DEVICE, "cpu")}
    card, cpu = steps[DEVICE], steps["cpu"]
    for key in ("cutoff", "cutoff_p", "logrank", "logrank_p", "km_median", "features"):
        if card[key] != cpu[key]:
            fail(f"analysis: survival {key} differs card {card[key]} against cpu {cpu[key]}")
    if card["cv_cindex"] != cpu["cv_cindex"]:
        diff = np.max(np.abs(np.subtract(card["cv_cindex"], cpu["cv_cindex"])))
        fail(f"analysis: fold C-indices differ card against cpu by {diff:.3e}")
    errs = {}
    for key in ("coef", "se"):
        a, b = card[key], cpu[key]
        errs[key] = float(np.max(np.abs(a - b) / np.abs(b)))
        if not (np.isfinite(a).all() and errs[key] <= COX_RTOL):
            fail(f"analysis: Cox {key} card against cpu rel diff {errs[key]:.3e} "
                 f"(tol {COX_RTOL}): {a} vs {b}")
    if not 0 < card["cv_cindex_mean"] < 1:
        fail(f"analysis: CV C-index {card['cv_cindex_mean']}")
    t = time.perf_counter()  # again, past the first call's one-time library loads
    build_cox_model(cox, "OS_MONTHS", "OS_STATUS", eval_time=float(np.median(time_[keep])),
                    device=DEVICE)
    warm_s = time.perf_counter() - t
    print(f"analysis: survival DirectPred through the training CLI {cli_s:.3f} s, launches "
          f"{launches}; test risk of {int(keep.sum())} samples: cut-off {card['cutoff']:.5g} "
          f"(p {card['cutoff_p']:.3g}), log-rank {card['logrank']:.3f} (p {card['logrank_p']:.3g}), "
          f"KM medians {card['km_median']}; Cox on {card['features']}: coef "
          f"{np.round(card['coef'], 5).tolist()}, fold C-indices "
          f"{np.round(card['cv_cindex'], 5).tolist()} (mean {card['cv_cindex_mean']:.5f}), "
          f"AUC at the median time {card['cv_auc_mean']}; card against cpu: cut-off, C-indices "
          f"equal, coef rel {errs['coef']:.2e}, se rel {errs['se']:.2e} (tol {COX_RTOL}); "
          f"build_cox_model {card['cox_s']:.3f} s on {DEVICE} (again {warm_s:.3f} s), "
          f"{cpu['cox_s']:.3f} s on cpu", flush=True)
    return launches, out, {"cli_s": cli_s, "cutoff": card["cutoff"],
                           "cv_cindex_mean": card["cv_cindex_mean"],
                           "cv_auc_mean": card["cv_auc_mean"], "cox_rel_err": errs,
                           "build_cox_model_s": {DEVICE: card["cox_s"], "again": warm_s,
                                                 "cpu": cpu["cox_s"]}}


def clustering_and_batches(workdir: Path, out: Path) -> dict:
    """Phase 13 (d): the survival run's test embeddings: silhouette-optimal
    KMeans over k = 2..10, Louvain on the 15-NN graph and AMI/ARI against
    the subtype labels, card against CPU (the same labels and k,
    silhouettes within CLUSTER_TOL); the Sinkhorn transport cost between
    the cohort's halves with a shift planted in the second, and the optimal
    transport alignment, card against CPU (SINKHORN_RTOL, ALIGN_TOL); the
    alignment must lower the cost."""
    import numpy as np
    from flexynesis_torch.utils.batch_correction import (
        compute_transport_cost,
        optimal_transport_align,
    )
    from flexynesis_torch.utils.clustering import (
        compute_ami_ari,
        get_optimal_clusters,
        louvain_clustering,
    )
    from flexynesis_torch.utils.csvio import Table, read_matrix, read_table

    samples, cols, E = read_matrix(str(out / "fit.embeddings_test.csv"))
    names, clin_cols, clin = read_table(str(workdir / "fit_data" / "test" / "clin.csv"))
    by_name = dict(zip(names, clin))
    subtype = [by_name[s][clin_cols.index("subtype")] or np.nan for s in samples]
    res, secs = {}, {}
    for device in (DEVICE, "cpu"):
        t = time.perf_counter()
        labels, k, table = get_optimal_clusters(E, 2, 10, device=device)
        louvain, _, _ = louvain_clustering(E, k=15, device=device)
        secs[device] = time.perf_counter() - t
        res[device] = (labels, k, table.column("silhouette_score"), louvain)
    (lc, kc, sc, vc), (lp, kp, sp, vp) = res[DEVICE], res["cpu"]
    sil_err = float(np.max(np.abs(sc - sp)))
    if kc != kp or not (lc == lp).all() or sil_err > CLUSTER_TOL:
        fail(f"analysis: KMeans card against cpu: k {kc} vs {kp}, labels equal "
             f"{bool((lc == lp).all())}, silhouettes max diff {sil_err:.3e}")
    if not np.array_equal(vc, vp):
        fail("analysis: Louvain partitions differ card against cpu")
    scores = {"kmeans": compute_ami_ari(lc, subtype), "louvain": compute_ami_ari(vc, subtype)}

    half = len(E) // 2
    batch = np.r_[np.zeros(half), np.ones(len(E) - half)].astype(int)
    shifted = E.copy()
    shifted[half:] = 1.5 * shifted[half:] + 2.0
    cost, aligned, align_s = {}, {}, {}
    for device in (DEVICE, "cpu"):
        t = time.perf_counter()
        cost[device] = compute_transport_cost(shifted, batch, device=device)
        aligned[device] = optimal_transport_align(Table(samples, cols, shifted), batch,
                                                  device=device)[0].values
        align_s[device] = time.perf_counter() - t
    cost_err = abs(cost[DEVICE] - cost["cpu"]) / abs(cost["cpu"])
    align_err = float(np.max(np.abs(aligned[DEVICE] - aligned["cpu"])))
    if cost_err > SINKHORN_RTOL or not np.allclose(aligned[DEVICE], aligned["cpu"],
                                                   rtol=ALIGN_TOL, atol=ALIGN_TOL):
        fail(f"analysis: transport card against cpu: cost rel {cost_err:.3e} (tol "
             f"{SINKHORN_RTOL}), alignment max abs {align_err:.3e} (tol {ALIGN_TOL})")
    after = compute_transport_cost(aligned[DEVICE], batch, device=DEVICE)
    if not after < cost[DEVICE]:
        fail(f"analysis: the alignment did not lower the transport cost: {cost[DEVICE]} -> {after}")
    print(f"analysis: {len(E)} test embeddings x {E.shape[1]}: KMeans k = {kc} (silhouettes "
          f"{np.round(sc, 4).tolist()}), Louvain {len(set(vc.tolist()))} communities; against "
          f"subtype {json.dumps(scores)}; card against cpu equal, silhouettes max diff "
          f"{sil_err:.2e}; {secs[DEVICE]:.3f} s on {DEVICE}, {secs['cpu']:.3f} s on cpu; "
          f"transport cost {cost[DEVICE]:.5f} (rel diff {cost_err:.2e}), aligned "
          f"{after:.5f} (max abs diff {align_err:.2e}); {align_s[DEVICE]:.3f} s on {DEVICE}, "
          f"{align_s['cpu']:.3f} s on cpu", flush=True)
    return {"k": kc, "ami_ari": scores, "silhouette_err": sil_err, "seconds": secs,
            "transport_cost": cost[DEVICE], "aligned_cost": after, "cost_rel_err": cost_err,
            "align_err": align_err, "transport_seconds": align_s}


def analysis_phase(workdir: Path) -> tuple:
    """Phase 13: co-expression at a cohort's width, the GNN on a
    co-expression network, survival analysis after a survival DirectPred,
    clustering and batch correction on its embeddings. No kernel of the port
    lies on these paths: B1, B2 and B3 launch no time."""
    t = time.perf_counter()
    summary = {"coexpression": coexpression_cohort(workdir)}
    gnn_launches, summary["gnn_coexpression"] = gnn_on_coexpression(workdir)
    surv_launches, out, summary["survival"] = survival_analysis(workdir)
    summary["clustering"] = clustering_and_batches(workdir, out)
    summary["seconds"] = time.perf_counter() - t
    print(f"analysis: phase 13 in {summary['seconds']:.1f} s", flush=True)
    return {"analysis_gnn_coexpression": gnn_launches,
            "analysis_survival_directpred": surv_launches}, summary



# phase 14: the device mesh, the 8-bit trial moments, GradientShap's noise
MESH_K = 16  # a round of TRIALS trials over two shards of one card
MESH_EPOCHS = 5
MESH_SHARDS = 2
STALL_EPOCHS, STALL_PATIENCE = 12, 2  # the round whose shards stall apart
GRID_SHARDS = 5  # the fine-tuning grid's 45 trials, 9 a shard
Q8_SHARE = 0.01  # of the 8-bit codes, the most that may part (by one) card against CPU
SHAP_STDEV, SHAP_DRAWS = 0.1, 5
ATTR_SAMPLES, ATTR_STEPS, ATTR_BATCH = 10_250, 5, 2048  # JAX's sharded-attribution test
ATTR_TOL = dict(rtol=1e-4, atol=1e-7)  # JAX's tolerance for it
MESH_DEVICES = ("cuda:0", "cuda:0")


def _launches():
    from flexynesis_torch.kernels.fused_linear import (
        fused_linear_bn_relu as b1,
        fused_linear_bn_relu_eval as b2,
    )
    from flexynesis_torch.kernels.mmd import gaussian_kernel_mean as b3

    return b1, b2, b3


def _count(fn):
    """(fn's result, its (B1, B2, B3) launches)."""
    kernels = _launches()
    for k in kernels:
        k.launches = 0
    out = fn()
    return out, tuple(k.launches for k in kernels)


def _q8_gap(a, b) -> dict:
    """How two Q8 moments (card, cpu) part: the share of codes that differ,
    the largest difference, the share that differ by more than one, the
    share of rows whose scale parts by more than 1e-3 (relative) and the
    largest scale gap."""
    import torch

    diff = (a.q.cpu().long() - b.q.long()).abs()
    s_gap = ((a.s.cpu() - b.s) / b.s).abs()
    return {"share": float((diff > 0).float().mean()), "max": int(diff.max()),
            "share_beyond_one": float((diff > 1).float().mean()),
            "noisy_rows": float((s_gap > 1e-3).float().mean()), "scale_gap": float(s_gap.max())}


def _q8_report(card_state, cpu_state) -> dict:
    """The worst of ``_q8_gap`` over the Q8 first moments and over the second
    moments of two SR-Adam states: {"m": ..., "v": ...}."""
    from flexynesis_torch.ops.sr_adam import Q8

    out = {}
    for kind, mine, theirs in (("m", card_state.m, cpu_state.m), ("v", card_state.v, cpu_state.v)):
        worst = {"share": 0.0, "max": 0, "share_beyond_one": 0.0, "noisy_rows": 0.0,
                 "scale_gap": 0.0}
        for a, b in zip(mine, theirs):
            if isinstance(a, Q8):
                worst = {k: max(v, _q8_gap(a, b)[k]) for k, v in worst.items()}
        out[kind] = worst
    return out


def _bf16_report(card_params, cpu_params, lrs, what: str):
    """(entries parting, entries, entries beyond 3 ulps) of the bfloat16
    leaves; fails where an entry beyond 3 bfloat16 ulps of max(|a|, |b|) +
    3 x lr also parts by more than 6 x lr."""
    import torch

    n_diff = n_all = n_noise = 0
    for a, b in zip(card_params, cpu_params):
        if a.dtype != torch.bfloat16:
            continue
        lr = lrs.cpu().reshape((-1,) + (1,) * (a.dim() - 1))
        ulps = _bf16_ulps(a, b, 3 * lr)
        gap = (a.detach().float().cpu() - b.float()).abs()
        noise = ulps > 3
        n_diff, n_all, n_noise = (n_diff + int((ulps > 0).sum()), n_all + ulps.numel(),
                                  n_noise + int(noise.sum()))
        if bool((gap > 6 * lr)[noise].any()):
            fail(f"mesh: {what}: a bfloat16 entry parts beyond 3 ulps and 6 x lr")
    return n_diff, n_all, n_noise


def check_int8_steps(config, cohort):
    """SR-Adam with 8-bit moments at the full-width DirectPred leaves, K =
    MESH_K, card against CPU. (1) ``sr_adam_step`` on the same leaves,
    1e-5 x N(0, 1) gradients (the clip scale exactly 1) and fixed seeds,
    three steps: the codes equal but for at most Q8_SHARE of them, by one
    (a square root, log or exp may part in the last place), the scales
    within rtol 1e-5; at most 1e-4 of the bfloat16 parameters part, each
    within 3 bfloat16 ulps of max(|card|, |cpu|) + 3 x lr (a decoded v one
    ulp apart moves an update across a stochastic-rounding threshold). (2) Three SR stacked steps of a fused round
    (forward, backward and update on each device, the same initial
    parameters, batches and SR seeds, dropout 0): losses rtol 1e-4; the codes
    equal but for at most Q8_SHARE of them, and for at most a tenth of that
    by more than one (an element whose moment is a rounding-noise-sized
    share of its row's scale: the first chip runs parted 4.7e-4 of the
    codes, by up to 11); at most 1% of the rows with a scale more than 1e-3
    apart; bfloat16
    parameters: at most 1% of the entries part, each within 3 bfloat16 ulps
    of max(|card|, |cpu|) + 3 x lr, but for 1e-4 of them within 6 x lr."""
    import numpy as np
    import torch
    from flexynesis_torch.models.direct_pred import DirectPred
    from flexynesis_torch.ops.sr_adam import Q8, sr_adam_init, sr_adam_step
    from flexynesis_torch.parallel.trials import _gather, _init_stacked, _Round

    lrs = np.geomspace(1e-4, 1e-2, MESH_K)
    rounds = {}
    for device in (DEVICE, "cpu"):
        m = _no_dropout(DirectPred(config, cohort, target_variables=["subtype"], device=device))
        params, buffers = _init_stacked(m, [3] * MESH_K)
        rounds[device] = _Round(m, params, buffers, lrs=lrs, seeds=[3] * MESH_K,
                                moment_dtype="int8")
    n_q8 = sum(isinstance(x, Q8) for x in rounds["cpu"].opt_state.m)
    if n_q8 == 0:
        fail("mesh: the int8 round holds no 8-bit moment")

    # (1) the optimizer alone on the same inputs
    gen = torch.Generator().manual_seed(11)
    grads = [[torch.randn(v.shape, generator=gen) * 1e-5 for v in rounds["cpu"].views]
             for _ in range(3)]
    seeds = [torch.arange(MESH_K) * 7919 + 2 ** 32 - 1 - 97 * s for s in range(3)]
    runs = {}
    for device, r in rounds.items():
        leaves = [v.detach().clone() for v in r.views]
        state = sr_adam_init(leaves, "int8")
        for g, seed in zip(grads, seeds):
            leaves, state = sr_adam_step(leaves, state, [x.to(r.device) for x in g], r.lrs,
                                         seed.to(r.device), trial_axis=True)
        runs[device] = (leaves, state)
    opt = _q8_report(runs[DEVICE][1], runs["cpu"][1])
    n_diff, n_all, _ = _bf16_report(runs[DEVICE][0], runs["cpu"][0],
                                    rounds["cpu"].lrs, "int8 sr_adam_step")
    lr_pad = rounds["cpu"].lrs.reshape(-1, 1, 1)
    ulp = max((float(_bf16_ulps(a, b, 3 * lr_pad).max())
               for a, b in zip(runs[DEVICE][0], runs["cpu"][0]) if a.dtype == torch.bfloat16),
              default=0.0)
    print(f"mesh: int8 sr_adam_step x3 (K={MESH_K}, {n_q8} 8-bit first moments) card against "
          f"CPU on the same gradients: {json.dumps(opt)}; {n_diff} of {n_all} bfloat16 "
          f"entries part, by at most {ulp:.2f} ulps", flush=True)
    if (any(opt[k]["share"] > Q8_SHARE or opt[k]["max"] > 1 or opt[k]["scale_gap"] > 1e-5
            for k in opt) or n_diff > 1e-4 * n_all or ulp > 3):
        fail("mesh: int8 sr_adam_step parts card against CPU beyond the stated tolerance")

    # (2) three stacked steps
    perm = torch.randperm(len(cohort), generator=torch.Generator().manual_seed(6))
    perm = perm[: 3 * BATCH].reshape(3, BATCH)
    step_seeds = [torch.tensor([2 ** 32 - 1 - 97 * s]) for s in range(3)]
    losses = {}
    for device, r in rounds.items():
        data = r.model.make_batch(cohort)
        (losses[device], _), launches = _count(lambda: (torch.stack([
            r.step(_gather(data, p.to(r.device)), s.to(r.device)).cpu()
            for p, s in zip(perm, step_seeds)]), None))
        if device == DEVICE and launches != (3 * B1_PER_STEP, 0, 0):
            fail(f"mesh: three int8 stacked steps launched (B1, B2, B3) {launches}, expected "
                 f"({3 * B1_PER_STEP}, 0, 0)")
    card, cpu = rounds[DEVICE], rounds["cpu"]
    steps = _q8_report(card.opt_state, cpu.opt_state)
    n_diff, n_all, n_noise = _bf16_report([card.params[n] for n in card.stacked.leaf_names],
                                          [cpu.params[n] for n in cpu.stacked.leaf_names],
                                          card.lrs, "int8 stacked steps")
    rel = float(((losses[DEVICE] - losses["cpu"]) / losses["cpu"]).abs().max())
    print(f"mesh: 3 int8-moment SR stacked steps (K={MESH_K}) card against CPU: losses max "
          f"rel diff {rel:.3e}; codes {json.dumps(steps)}; {n_diff} of {n_all} bfloat16 "
          f"entries part ({n_noise} beyond 3 ulps)", flush=True)
    if rel > 1e-4:
        fail(f"mesh: int8 steps: card losses {losses[DEVICE].tolist()} against the CPU's "
             f"{losses['cpu'].tolist()} (rtol 1e-4)")
    if any(steps[k]["share"] > Q8_SHARE or steps[k]["share_beyond_one"] > Q8_SHARE / 10
           or steps[k]["noisy_rows"] > 0.01 for k in steps):
        fail("mesh: int8 stacked steps: the codes part card against CPU beyond the stated "
             "tolerance")
    if n_diff > 0.01 * n_all or n_noise > 1e-4 * n_all:
        fail(f"mesh: int8 steps: {n_diff} of {n_all} bfloat16 entries part (1%), {n_noise} "
             "beyond 3 ulps (1e-4)")


def _step_ms(r, batches) -> float:
    """Median host-clock ms of one synchronised stacked step over 20."""
    import torch

    for b in batches[:3]:
        r.step(b)
    times = []
    for i in range(20):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r.step(batches[i % len(batches)])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    return statistics.median(times) * 1e3


def int8_rounds(config, cohort) -> dict:
    """A MESH_K-trial ParallelTrials round of MESH_EPOCHS epochs with int8
    and with bfloat16 moments on the cohort's 400/100 split: per-trial best
    validation losses side by side, B1/B2 launches (3 per stacked step and
    per validation), the stacked step's time and the card's peak allocated
    memory for each moment type."""
    import numpy as np
    import torch
    from flexynesis_torch.models.direct_pred import DirectPred
    from flexynesis_torch.parallel.trials import (ParallelTrials, _gather, _init_stacked,
                                                  _Round)
    from flexynesis_torch.train.trainer import train_val_split

    tr, va = train_val_split(len(cohort), VAL_SIZE)
    lrs = np.geomspace(1e-4, 1e-2, MESH_K)
    steps = MESH_EPOCHS * (len(tr) // BATCH)
    out = {}
    for moments in ("int8", "bfloat16"):
        m = DirectPred(config, cohort, target_variables=["subtype"], device=DEVICE)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        res, launches = _count(lambda: ParallelTrials(m, cohort, moment_dtype=moments).run(
            lrs, np.full(MESH_K, 3), train_idx=tr, val_idx=va, batch_size=BATCH,
            max_epochs=MESH_EPOCHS))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        want = (B1_PER_STEP * steps, B2_PER_FORWARD * MESH_EPOCHS, 0)
        if launches != want:
            fail(f"mesh: the {moments} round launched (B1, B2, B3) {launches}, expected {want}")
        if not np.all(np.isfinite(res["best_val_loss"])):
            fail(f"mesh: the {moments} round gave non-finite losses")
        params, buffers = _init_stacked(m, [3] * MESH_K)
        r = _Round(m, params, buffers, lrs=lrs, seeds=[3] * MESH_K, moment_dtype=moments)
        data = m.make_batch(cohort)
        batches = [_gather(data, torch.from_numpy(tr[i:i + BATCH]).to(DEVICE))
                   for i in range(0, len(tr) - BATCH + 1, BATCH)]
        out[moments] = {"best_val_loss": res["best_val_loss"].tolist(),
                        "launches": launches, "step_ms": _step_ms(r, batches),
                        "peak_gib": peak}
    gap = np.abs(np.asarray(out["int8"]["best_val_loss"]) - out["bfloat16"]["best_val_loss"])
    print(f"mesh: ParallelTrials rounds of {MESH_K} ({MESH_EPOCHS} epochs), best validation "
          f"losses int8 {np.round(out['int8']['best_val_loss'], 4).tolist()}, bfloat16 "
          f"{np.round(out['bfloat16']['best_val_loss'], 4).tolist()}: median gap "
          f"{float(np.median(gap)):.4f}, max {float(gap.max()):.4f}; stacked step "
          f"{out['int8']['step_ms']:.3f} ms int8, {out['bfloat16']['step_ms']:.3f} ms bfloat16 "
          f"(host clock, synchronised); peak allocated {out['int8']['peak_gib']:.3f} GiB int8, "
          f"{out['bfloat16']['peak_gib']:.3f} GiB bfloat16; launches (B1, B2, B3) "
          f"{out['int8']['launches']}", flush=True)
    return out


def noisy_shap(cohort) -> dict:
    """GradientShap with input noise (stdev SHAP_STDEV, SHAP_DRAWS draws, all
    four classes) of an unfused DirectPred at the headline width on the
    500-sample test cohort: the card against the CPU within MARKER_TOL, and
    its seconds on the card."""
    import numpy as np
    import torch
    from flexynesis_torch.interpret.attribution import gradient_shap
    from flexynesis_torch.models.direct_pred import DirectPred
    from flexynesis_torch.utils import prng

    cfg = {"latent_dim": LATENT, "hidden_dim_factor": HIDDEN_FACTOR,
           "supervisor_hidden_dim": SUP_HIDDEN, "lr": 1e-3, "epochs": 1, "batch_size": BATCH}
    got, seconds = {}, None
    for device in (DEVICE, "cpu"):
        m = DirectPred(cfg, cohort, target_variables=["subtype"], device=device)
        m.init_params(5)
        x = m.make_eval_x(cohort)
        n_class = m.output_dims["subtype"]

        def run():
            return gradient_shap(lambda xs: m._attribution_forward(xs, "subtype"), x,
                                 range(n_class), SHAP_DRAWS, False, prng.key(42),
                                 stdevs=SHAP_STDEV)

        if device == DEVICE:
            run()
            torch.cuda.synchronize()
            t = time.perf_counter()
        got[device] = [{k: v.detach().cpu().numpy() for k, v in a.items()} for a in run()]
        if device == DEVICE:
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t
    err = 0.0
    for a, b in zip(got[DEVICE], got["cpu"]):
        for k in a:
            if not np.allclose(a[k], b[k], **MARKER_TOL):
                fail(f"mesh: noisy GradientShap ({k}) parts card against CPU beyond "
                     f"rtol {MARKER_TOL['rtol']} / atol {MARKER_TOL['atol']}")
            err = max(err, float(np.abs(a[k] - b[k]).max()))
    print(f"mesh: GradientShap with input noise (stdev {SHAP_STDEV}, {SHAP_DRAWS} draws, "
          f"{len(cohort)} samples, 4 classes): {seconds:.3f} s on the card; card against CPU "
          f"max abs {err:.3e}", flush=True)
    return {"seconds": seconds, "max_abs_err": err}


ROUND_RTOL = 1e-2  # sharded against unsharded rounds on the card (see _same_rounds)


def _same_rounds(a, b, hist_a, hist_b, what: str) -> float:
    """Holds a sharded round ``a`` against the unsharded ``b`` (their
    per-epoch validation losses ``hist_*``): bit for bit where cuBLAS takes
    the same kernels for a shard's batched products as for the round's; it
    may not (its choice depends on the batch count), and Adam turns the
    last-bit gaps of shift-only biases' rounding-noise gradients into steps
    of about lr (``tests/test_torch_trials.py``), so: every trial's best loss
    within ROUND_RTOL, its best epoch equal or a near tie (the unsharded
    loss at the sharded best epoch within ROUND_RTOL of its best), and the
    same epochs run. Returns the largest relative gap."""
    import numpy as np

    la, lb = np.asarray(a["best_val_loss"]), np.asarray(b["best_val_loss"])
    if not np.array_equal(np.isfinite(la), np.isfinite(lb)):
        fail(f"mesh: {what}: the sharded and unsharded rounds diverge in other trials")
    fin = np.isfinite(lb)
    rel = float((np.abs(la - lb)[fin] / np.abs(lb[fin])).max()) if fin.any() else 0.0
    ea, eb = np.asarray(a["best_epoch"]), np.asarray(b["best_epoch"])
    hb = np.asarray(hist_b)
    ties = [k for k in range(len(ea)) if ea[k] != eb[k]]
    near = all(abs(hb[ea[k] - 1, k] - lb[k]) <= ROUND_RTOL * abs(lb[k]) for k in ties)
    exact = rel == 0 and not ties
    print(f"mesh: {what}: sharded against unsharded: "
          + ("bit for bit" if exact else
             f"best losses up to {rel:.3e} apart (relative), best epochs "
             f"{ea.tolist()} against {eb.tolist()}")
          + f", epochs run {a['epochs_run']} against {b['epochs_run']}", flush=True)
    if rel > ROUND_RTOL or not near or a["epochs_run"] != b["epochs_run"]:
        fail(f"mesh: {what}: the sharded round parts from the unsharded one beyond "
             f"rtol {ROUND_RTOL} (best losses {la.tolist()} against {lb.tolist()})")
    return rel


def check_shard_launches():
    """B1 and B2 at the DirectPred round's three blocks, K = MESH_K and a
    shard's MESH_K / MESH_SHARDS trials planned for the whole round
    (``planned_for``), and B3's MMD term with the same trial counts: each
    trial bit for bit between the two launches."""
    import torch
    from flexynesis_torch.kernels.fused_linear import (fused_linear_bn_relu,
                                                       fused_linear_bn_relu_eval, planned_for)
    from flexynesis_torch.kernels.mmd import mmd_term_forward

    g = torch.Generator().manual_seed(21)
    K, k = MESH_K, MESH_K // MESH_SHARDS
    shapes = [(BATCH, GEX, int(GEX * HIDDEN_FACTOR)), (BATCH, CNV, int(CNV * HIDDEN_FACTOR)),
              (BATCH, 2 * LATENT, SUP_HIDDEN)]
    for B, F, H in shapes:
        x = torch.randn(B, F, generator=g).to(DEVICE)
        w = (torch.randn(K, F, H, generator=g) / F ** 0.5).to(DEVICE)
        v = [torch.randn(K, H, generator=g).to(DEVICE) for _ in range(3)]
        rv = (torch.rand(K, H, generator=g) + 0.5).to(DEVICE)
        outs = []
        for n in (K, k):
            with planned_for(K):
                args = (x, w[:n].contiguous(), *(t[:n].contiguous() for t in v))
                outs.append((fused_linear_bn_relu(*args)[0],
                             fused_linear_bn_relu_eval(*args, v[0][:n].contiguous(),
                                                       rv[:n].contiguous())))
        if not (torch.equal(outs[0][0][:k], outs[1][0]) and torch.equal(outs[0][1][:k], outs[1][1])):
            fail(f"mesh: B1/B2 at ({B}, {F}, {H}) give a shard's trials other bits than the "
                 "round's")
    z = torch.randn(K, BATCH, LATENT, generator=g).to(DEVICE)
    prior = torch.randn(200, LATENT, generator=g).to(DEVICE)
    if not torch.equal(mmd_term_forward(prior, z)[:k], mmd_term_forward(prior, z[:k].contiguous())):
        fail("mesh: B3's MMD term gives a shard's trials other bits than the round's")
    print(f"mesh: B1 and B2 at the round's three blocks and B3's MMD term: a shard's {k} "
          f"trials (planned for {K}) bit for bit with the round's launch", flush=True)


def sharded_rounds(config, cohort) -> dict:
    """Trial rounds split over MESH_SHARDS shards of one card
    ([cuda:0, cuda:0]) against the unsharded rounds (``_same_rounds``), after
    ``check_shard_launches``: a fused DirectPred round of MESH_K whose shards'
    trials stall at different epochs (lr 0.02 trials in the first shard,
    1e-4 in the second, patience STALL_PATIENCE; a first-shard trial must
    stall while the round runs on), a fused supervised_vae
    round of MESH_K and the fine-tuning grid (45 trials) over GRID_SHARDS
    shards (the same best cell, its loss within ROUND_RTOL). A shard
    launches each kernel as the unsharded round does for its trials, so
    every sharded count is the shards times the unsharded one."""
    import numpy as np
    import torch
    from flexynesis_torch.models.direct_pred import DirectPred
    from flexynesis_torch.models.supervised_vae import SupervisedVAE
    from flexynesis_torch.parallel.mesh import auto_trial_mesh, get_mesh
    from flexynesis_torch.parallel.trials import ParallelTrials
    from flexynesis_torch.train.finetune import FineTuner
    from flexynesis_torch.train.trainer import train_val_split

    auto = auto_trial_mesh(MESH_K)
    print(f"mesh: auto_trial_mesh({MESH_K}) on this {torch.cuda.device_count()}-card host: "
          f"{auto}", flush=True)
    if torch.cuda.device_count() == 1 and auto is not None:
        fail("mesh: auto_trial_mesh split a round over one card")
    mesh = get_mesh((("trial", MESH_SHARDS),), devices=MESH_DEVICES)
    tr, va = train_val_split(len(cohort), VAL_SIZE)
    check_shard_launches()
    launches, summary = {}, {}
    runs = (("directpred", DirectPred, np.r_[np.full(MESH_K // 2, 0.02),
                                             np.full(MESH_K // 2, 1e-4)],
             STALL_EPOCHS, STALL_PATIENCE),
            ("supervised_vae", SupervisedVAE, np.geomspace(1e-4, 3e-3, MESH_K), MESH_EPOCHS, -1))
    for name, cls, lrs, epochs, patience in runs:
        outs, hist = {}, {}
        for tag, mm in (("unsharded", None), ("sharded", mesh)):
            m = cls(config, cohort, target_variables=["subtype"], device=DEVICE)
            hist[tag] = []
            t = time.perf_counter()
            outs[tag], launches[f"mesh_{name}_{tag}"] = _count(lambda: ParallelTrials(
                m, cohort, mesh=mm).run(lrs, np.arange(MESH_K), train_idx=tr, val_idx=va,
                                        batch_size=BATCH, max_epochs=epochs,
                                        early_stop_patience=patience,
                                        on_epoch_end=lambda e, tl, vl: hist[tag].append(vl)))
            torch.cuda.synchronize()
            summary[f"{name}_{tag}_s"] = time.perf_counter() - t
        gap = _same_rounds(outs["sharded"], outs["unsharded"], hist["sharded"],
                           hist["unsharded"], f"the {name} round")
        one, both = launches[f"mesh_{name}_unsharded"], launches[f"mesh_{name}_sharded"]
        if both != tuple(MESH_SHARDS * x for x in one) or sum(one) == 0:
            fail(f"mesh: the sharded {name} round launched {both}, the unsharded {one}: "
                 f"expected {MESH_SHARDS} x the unsharded per kernel")
        out = outs["sharded"]
        stalled = np.asarray(out["best_epoch"]) + patience
        note = ""
        if patience > 0:
            # a first-shard trial stalled while the round ran on: no shard
            # stops the round alone
            if not stalled[: MESH_K // 2].min() < out["epochs_run"]:
                fail(f"mesh: no trial of the {name} round's first shard stalled before the "
                     f"round stopped (stall epochs {stalled.tolist()}, {out['epochs_run']} run)")
            note = (f"; stall epochs (best + {patience}) {stalled.tolist()}, the round ran "
                    f"{out['epochs_run']} of {epochs}")
        print(f"mesh: {name} round of {MESH_K} over {MESH_SHARDS} shards of cuda:0 against "
              f"the unsharded round: best losses {gap:.2e} apart (relative){note}; launches "
              f"(B1, B2, B3) per shard {one}, sharded total {both}; wall "
              f"{summary[f'{name}_sharded_s']:.2f} s sharded, "
              f"{summary[f'{name}_unsharded_s']:.2f} s unsharded", flush=True)

    # the fine-tuning grid: 9 (lr x freeze) cells x 5 folds on 100 samples
    grid_mesh = get_mesh((("trial", GRID_SHARDS),), devices=[MESH_DEVICES[0]] * GRID_SHARDS)
    ft = cohort.subset(np.arange(FT_SAMPLES))
    best = {}
    m = DirectPred(config, cohort, target_variables=["subtype"], device=DEVICE)
    m.init_params(8)
    start = {n: t.clone() for n, t in m.module.state_dict().items()}
    for tag, mm in (("unsharded", None), ("sharded", grid_mesh)):
        m.module.load_state_dict(start)
        best[tag], launches[f"mesh_finetune_grid_{tag}"] = _count(
            lambda: FineTuner(m, ft, max_epochs=3, mesh=mm)._grid_parallel(FT_SAMPLES, FT_FOLDS))
    (loss_s, lr_s, freeze_s, ep_s), (loss_u, lr_u, freeze_u, ep_u) = best["sharded"], \
        best["unsharded"]
    if (lr_s, freeze_s) != (lr_u, freeze_u) or abs(loss_s - loss_u) > ROUND_RTOL * abs(loss_u):
        fail(f"mesh: the sharded fine-tuning grid chose {best['sharded']}, the unsharded "
             f"{best['unsharded']}")
    one, both = launches["mesh_finetune_grid_unsharded"], launches["mesh_finetune_grid_sharded"]
    if both != tuple(GRID_SHARDS * x for x in one):
        fail(f"mesh: the sharded grid launched {both}, the unsharded {one}")
    print(f"mesh: fine-tuning grid of {FT_K} trials over {GRID_SHARDS} shards: best cell "
          f"{best['sharded']}, unsharded {best['unsharded']}; launches per shard {one}, total "
          f"{both}", flush=True)
    return launches, summary


def sharded_attribution() -> dict:
    """Both methods over ATTR_SAMPLES samples at the headline width (an
    unfused DirectPred, random weights from a seed), the sample axis split
    over [cuda:0, cuda:0] against the unsharded run within ATTR_TOL; the
    seconds of each."""
    import numpy as np
    import torch
    from flexynesis_torch.data.dataset import MultiOmicDataset
    from flexynesis_torch.interpret.attribution import METHODS
    from flexynesis_torch.models.direct_pred import DirectPred
    from flexynesis_torch.parallel.mesh import get_mesh

    rng = np.random.default_rng(12)
    cls = rng.integers(0, N_CLASSES, ATTR_SAMPLES).astype(np.float32)
    ds = MultiOmicDataset(
        dat={"gex": (rng.normal(size=(ATTR_SAMPLES, GEX)) + cls[:, None]).astype(np.float32),
             "cnv": rng.normal(size=(ATTR_SAMPLES, CNV)).astype(np.float32)},
        ann={"subtype": cls}, variable_types={"subtype": "categorical"},
        features={"gex": [f"g{i}" for i in range(GEX)], "cnv": [f"c{i}" for i in range(CNV)]},
        samples=[f"S{i}" for i in range(ATTR_SAMPLES)],
        label_mappings={"subtype": {i: f"grp{i}" for i in range(N_CLASSES)}})
    cfg = {"latent_dim": LATENT, "hidden_dim_factor": HIDDEN_FACTOR,
           "supervisor_hidden_dim": SUP_HIDDEN, "lr": 1e-3, "epochs": 1, "batch_size": BATCH}
    model = DirectPred(cfg, ds, target_variables=["subtype"], device=DEVICE)
    model.init_params(11)
    mesh = get_mesh((("data", len(MESH_DEVICES)),), devices=MESH_DEVICES)
    out = {}
    for method in METHODS:
        rows, secs = {}, {}
        for tag, mm in (("unsharded", None), ("sharded", mesh)):
            torch.cuda.synchronize()
            t = time.perf_counter()
            rows[tag], got = _count(lambda: model.compute_feature_importance(
                ds, "subtype", method=method, steps_or_samples=ATTR_STEPS,
                batch_size=ATTR_BATCH, mesh=mm))
            torch.cuda.synchronize()
            secs[tag] = time.perf_counter() - t
            if got != (0, 0, 0):
                fail(f"mesh: attribution launched (B1, B2, B3) {got}")
        a = np.asarray([r["importance"] for r in rows["sharded"]], np.float64)
        b = np.asarray([r["importance"] for r in rows["unsharded"]], np.float64)
        if not np.allclose(a, b, **ATTR_TOL):
            fail(f"mesh: sharded {method} parts from the unsharded run beyond {ATTR_TOL}")
        rel = float((np.abs(a - b) / np.maximum(np.abs(b), 1e-30)).max())
        out[method] = {**secs, "max_rel_diff": rel}
        print(f"mesh: {method} over {ATTR_SAMPLES} samples x {GEX + CNV} features "
              f"({ATTR_STEPS} steps, batches of {ATTR_BATCH}): sharded over "
              f"{len(MESH_DEVICES)} shards {secs['sharded']:.3f} s, unsharded "
              f"{secs['unsharded']:.3f} s; max rel diff {rel:.2e}", flush=True)
    return out


def data_parallel(config, cohort) -> tuple:
    """``distributed.initialize`` with a one-rank NCCL group (loopback TCP):
    a fused DirectPred's data-parallel fit (``fit(mesh=...)``, every
    collective run) equals the fit without a group bit for bit, with the
    same B1/B2 launches; ``partition_trials`` over the live topology returns
    the whole batch."""
    import socket

    import numpy as np
    import torch
    from flexynesis_torch.models.direct_pred import DirectPred
    from flexynesis_torch.parallel import distributed
    from flexynesis_torch.parallel.mesh import get_mesh
    from flexynesis_torch.train.trainer import train_val_split

    tr, va = train_val_split(len(cohort), VAL_SIZE)

    def fit(mesh):
        m = DirectPred(config, cohort, target_variables=["subtype"], device=DEVICE)
        return m.fit(cohort, tr, va, lr=1e-3, batch_size=BATCH, max_epochs=3, seed=4, mesh=mesh)

    plain, plain_launches = _count(lambda: fit(None))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    summary = distributed.initialize(f"tcp://127.0.0.1:{port}", 1, 0)
    try:
        if torch.distributed.get_backend() != "nccl":
            fail("mesh: the one-rank group is not NCCL")
        sugg = [{"i": i} for i in range(MESH_K)]
        if distributed.partition_trials(sugg) != sugg:
            fail("mesh: partition_trials over one rank did not return the whole batch")
        grouped, dp_launches = _count(lambda: fit(get_mesh((("data", 1),))))
    finally:
        distributed.shutdown()
    same = grouped.history == plain.history and all(
        torch.equal(grouped.state[n], t) for n, t in plain.state.items())
    if not same or dp_launches != plain_launches:
        fail(f"mesh: the one-rank data-parallel fit parts from the plain fit (histories "
             f"{grouped.history['val_loss']} / {plain.history['val_loss']}, launches "
             f"{dp_launches} / {plain_launches})")
    print(f"mesh: distributed.initialize -> {summary}; the data-parallel fit over a one-rank "
          f"NCCL group = the plain fit bit for bit ({len(plain.history['val_loss'])} epochs, "
          f"val {plain.history['val_loss'][-1]:.6f}); launches (B1, B2, B3) {dp_launches}; "
          "partition_trials returned the whole batch; two ranks need two cards (not run)",
          flush=True)
    return {"data_parallel_fit": dp_launches}, {"summary": summary}


def mesh_phase(cohort) -> tuple:
    """Phase 14: the 8-bit trial moments (card against CPU, rounds side by
    side), GradientShap with input noise, trial rounds and the fine-tuning
    grid split over shards of one card, attribution split over two shards,
    and the data-parallel fit over a one-rank NCCL group."""
    config = {"latent_dim": LATENT, "hidden_dim_factor": HIDDEN_FACTOR,
              "supervisor_hidden_dim": SUP_HIDDEN, "lr": 1e-3, "epochs": MESH_EPOCHS,
              "batch_size": BATCH, "fused_kernels": True}
    t = time.perf_counter()
    check_int8_steps(config, cohort)
    summary = {"int8_rounds": int8_rounds(config, cohort), "noisy_shap": noisy_shap(cohort)}
    launches, summary["sharded_rounds"] = sharded_rounds(config, cohort)
    summary["sharded_attribution"] = sharded_attribution()
    dp_launches, summary["data_parallel"] = data_parallel(config, cohort)
    launches.update(dp_launches)
    for moments in ("int8", "bfloat16"):
        launches[f"mesh_{moments}_round"] = summary["int8_rounds"][moments]["launches"]
    summary["seconds"] = time.perf_counter() - t
    print(f"mesh: phase 14 in {summary['seconds']:.1f} s", flush=True)
    return launches, summary


JOBLIB_EPOCHS = 3  # phase 15's default-command run, cut from phase 5's 10 epochs
JOBLIB_REPS = 5  # timed calls of each artifact reader and writer (the median is kept)
JOBLIB_FIXTURE = REPO / "tests" / "fixtures" / "joblib"  # a model the JAX CLI trained


def _serve_cli(weights, artifacts, test, out: Path, device: str, what: str):
    """The inference CLI over ``test``, with B1, B2 and B3 counted from 0;
    returns the launches."""
    from flexynesis_torch.__main__ import main as cli

    kernels = _launch_counts()
    for k in kernels:
        k.launches = 0
    if cli(["--pretrained_model", str(weights), "--artifacts", str(artifacts),
            "--data_path_test", str(test), "--outdir", str(out), "--prefix", "smoke",
            "--disable_marker_finding", "--device", device]) != 0:
        fail(f"{what}: the inference CLI on {device} returned nonzero")
    return tuple(k.launches for k in kernels)


def _same_files(a: Path, b: Path, what: str) -> None:
    """The two inference runs wrote the same tables, bit for bit."""
    for name in ("smoke.embeddings_test.csv", "smoke.predicted_labels.csv", "smoke.stats.csv"):
        if (a / name).read_bytes() != (b / name).read_bytes():
            fail(f"{what}: {name} differs between {a.name} and {b.name}")


def _median_s(fn, reps: int = JOBLIB_REPS) -> float:
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t)
    return statistics.median(times)


def joblib_phase(workdir: Path, importer_cache: "ImportOnce") -> tuple:
    """Phase 15: joblib artifacts, without joblib or sklearn on this machine.
    (a) phase 5's training command without ``--safetensors`` (the CLI's
    default; phase 5's import reused), cut to JOBLIB_EPOCHS: B1/B2 launches
    as its steps and validations give them, ``fit.artifacts.joblib`` and no
    JSON; (b) the run's 2000-sample training cohort served from that file and
    from a ``.artifacts.json`` written from the state it loads to, bit for
    bit; (c) the JAX-trained fixture ``tests/fixtures/joblib`` served from its
    ``.joblib`` and its ``.json`` on the card (bit for bit) and on the CPU
    (TOL); (d) the artifact readers' and writers' seconds on (a)'s file.
    Returns the launches and summary."""
    from flexynesis_torch import inference
    from flexynesis_torch.utils import joblib_io
    from flexynesis_torch.utils.csvio import read_table

    t0 = time.perf_counter()
    data, out = workdir / "fit_data", workdir / "joblib_out"
    config = workdir / "joblib_hpo.yaml"
    config.write_text(HPO_CONFIG % ("DirectPred", LATENT, HIDDEN_FACTOR, SUP_HIDDEN,
                                    JOBLIB_EPOCHS, BATCH))
    args = [a for a in train_args(data, config, out, DEVICE) if a != "--safetensors"]
    with importer_cache:
        model, launches, cli_s = cli_run(args, "joblib: phase 5's command without --safetensors")
    want, n_fit, _ = expected_launches(model)
    epochs = model.train_result.epochs_run
    if launches != (*want, 0):
        fail(f"joblib: launches {launches}, expected {(*want, 0)} ({epochs} epochs x "
             f"{n_fit // BATCH} steps)")
    art, weights = out / "fit.artifacts.joblib", out / "fit.final_model.safetensors"
    if not art.exists() or (out / "fit.artifacts.json").exists():
        fail(f"joblib: the run wrote {sorted(p.name for p in out.glob('fit.artifacts.*'))}, "
             "expected fit.artifacts.joblib alone")

    # (b) the run's own artifact, and the JSON the port writes from its state
    state = inference.load_and_sniff_artifacts(str(art))
    json_art = workdir / "joblib_state.artifacts.json"
    inference.write_artifacts(state, str(json_art))
    if inference.load_and_sniff_artifacts(str(json_art)) != state:
        fail("joblib: the JSON written from the .joblib's state loads to another state")
    classes = len(state["label_encoders"]["subtype"]["categories"][0])
    serve_launches = {}
    for kind, path in (("joblib", art), ("json", json_art)):
        serve_launches[kind] = _serve_cli(weights, path, data / "train",
                                          workdir / f"joblib_served_{kind}", DEVICE, "joblib")
        read_outputs(workdir / f"joblib_served_{kind}", FIT_TRAIN, classes)
    _same_files(workdir / "joblib_served_joblib", workdir / "joblib_served_json",
                "joblib: the run's cohort")
    want_serve = (0, CLI_FORWARDS * B2_PER_FORWARD, 0)
    if any(v != want_serve for v in serve_launches.values()):
        fail(f"joblib: serving launches {serve_launches}, expected {want_serve} each")

    # (c) the JAX-written model, on the card from both files and on the CPU
    fx_weights, fx_test = JOBLIB_FIXTURE / "job.final_model.safetensors", JOBLIB_FIXTURE / "test"
    fx_state = inference.load_and_sniff_artifacts(str(JOBLIB_FIXTURE / "job.artifacts.joblib"))
    if fx_state != inference.load_and_sniff_artifacts(str(JOBLIB_FIXTURE / "job.artifacts.json")):
        fail("joblib: the fixture's .joblib and .json load to different states")
    fx_config = json.loads((JOBLIB_FIXTURE / "job.final_model_config.json").read_text())
    fx_n, fx_latent = len(read_table(str(fx_test / "clin.csv"))[0]), fx_config["latent_dim"]
    fx_launches = {}
    for kind, device in (("joblib", DEVICE), ("json", DEVICE), ("joblib", "cpu")):
        fx_launches[f"{kind}_{device}"] = _serve_cli(
            fx_weights, JOBLIB_FIXTURE / f"job.artifacts.{kind}", fx_test,
            workdir / f"joblib_fixture_{kind}_{device}", device, "joblib: the fixture")
    _same_files(workdir / f"joblib_fixture_joblib_{DEVICE}",
                workdir / f"joblib_fixture_json_{DEVICE}", "joblib: the fixture")
    fx_classes = len(fx_state["label_encoders"]["subtype"]["categories"][0])
    compare_outputs(workdir / f"joblib_fixture_joblib_{DEVICE}",
                    workdir / "joblib_fixture_joblib_cpu", fx_n, fx_classes,
                    "joblib: the JAX-trained fixture served", latent=fx_latent)
    if fx_launches[f"joblib_{DEVICE}"] != want_serve or fx_launches["joblib_cpu"] != (0, 0, 0):
        fail(f"joblib: the fixture's serving launches {fx_launches}")

    # (d) the codec alone on the headline artifact
    raw = joblib_io.load(str(art))
    again = workdir / "joblib_again.artifacts.joblib"
    joblib_io.dump(raw, str(again))
    if inference.load_and_sniff_artifacts(str(again)) != state:
        fail("joblib: what the codec read and wrote back loads to another state")
    seconds = {
        "codec_read_s": _median_s(lambda: joblib_io.load(str(art))),
        "codec_write_s": _median_s(lambda: joblib_io.dump(raw, str(again))),
        "artifact_read_s": _median_s(lambda: inference.load_and_sniff_artifacts(str(art))),
        "artifact_write_s": _median_s(
            lambda: inference.write_artifacts(state, str(again), as_json=False)),
        "json_read_s": _median_s(lambda: inference.load_and_sniff_artifacts(str(json_art))),
        "json_write_s": _median_s(lambda: inference.write_artifacts(state, str(json_art))),
    }
    widths = {k: len(v) for k, v in state["feature_lists"].items()}
    summary = {"cli_s": cli_s, "epochs": epochs, "launches": launches,
               "serve_launches": serve_launches, "fixture_launches": fx_launches,
               "artifact_bytes": art.stat().st_size, "json_bytes": json_art.stat().st_size,
               "features": widths, **seconds, "seconds": time.perf_counter() - t0}
    print(f"joblib: the default command ({epochs} epochs) CLI {cli_s:.3f} s, launches B1 "
          f"{launches[0]}, B2 {launches[1]}, B3 {launches[2]}; fit.artifacts.joblib "
          f"{summary['artifact_bytes']} bytes ({widths}); the {FIT_TRAIN}-sample cohort served "
          f"alike from it and from its JSON, bit for bit; the JAX-trained fixture alike "
          f"from .joblib and .json on {DEVICE}, and on the CPU within {TOL}", flush=True)
    print("joblib: median seconds (host clock) " + json.dumps(seconds), flush=True)
    return ({"joblib_training": launches, "joblib_serving": serve_launches["joblib"],
             "joblib_fixture_serving": fx_launches[f"joblib_{DEVICE}"]}, summary)


LIB_FOLDS, LIB_EPOCHS = 3, 3  # phase 16: cv_splits and the epochs of its every fit
LIB_SEQ_ITER = 2  # the sequential-fold search: 2 suggestions, asked as one batch of 2
LIB_LRS = (1e-4, 3e-4, 1e-3, 3e-3)  # the stacked DirectPred CV round: K = 4 x 3 = 12
LIB_VAE_LRS = (3e-4, 3e-3)  # the stacked supervised_vae CV round: K = 2 x 3 = 6
LAPLACIAN_K = 5
LAPLACIAN_TOL = dict(rtol=1e-4, atol=1e-6)  # JAX's sharded-score test's tolerance


def _lib_tuner(train, model_class: str, workdir: Path, name: str, **kw):
    """A ``--use_cv`` tuner of LIB_FOLDS folds over phase 5's training set on
    DEVICE, its space TRIAL_CONFIG's (one fused architecture, lr free,
    LIB_EPOCHS epochs at batch BATCH)."""
    from flexynesis_torch.models import MODEL_REGISTRY
    from flexynesis_torch.train.hpo import HyperparameterTuning

    config = workdir / f"{name}.yaml"
    config.write_text((TRIAL_CONFIG % (LATENT, HIDDEN_FACTOR, SUP_HIDDEN, LIB_EPOCHS, BATCH))
                      .replace("DirectPred:", f"{model_class}:"))
    return HyperparameterTuning(train, MODEL_REGISTRY[model_class], model_class, ["subtype"],
                                config_path=str(config), use_cv=True, cv_splits=LIB_FOLDS,
                                device=DEVICE, **kw)


def _lib_params(lr: float) -> dict:
    return {"latent_dim": LATENT, "hidden_dim_factor": HIDDEN_FACTOR, "lr": lr,
            "supervisor_hidden_dim": SUP_HIDDEN, "epochs": LIB_EPOCHS, "batch_size": BATCH,
            "fused_kernels": True}


def sequential_folds(train, workdir: Path) -> tuple:
    """16(a): ``perform_tuning`` of LIB_SEQ_ITER suggestions (``batch_ask``
    2) with ``parallel_folds`` False: LIB_FOLDS fresh fits of each
    suggestion over ``kfold_indices``, then the full-set retrain. B1 must
    launch in every step and B2 in every validation as the folds' sizes
    predict, and no pipelined ask session may open."""
    import numpy as np
    import torch
    from flexynesis_torch.kernels.fused_linear import ROW_TILE
    from flexynesis_torch.train import gp
    from flexynesis_torch.train.trainer import kfold_indices

    tuner = _lib_tuner(train, "DirectPred", workdir, "lib_sequential", n_iter=LIB_SEQ_ITER,
                       batch_ask=2)
    tuner.parallel_folds = False
    sessions, real = [], gp.BayesianOptimizer.ask_session

    def spy(self, *a, **kw):
        sessions.append(a)
        return real(self, *a, **kw)

    gp.BayesianOptimizer.ask_session = spy
    try:
        t = time.perf_counter()
        with Tee() as log:
            (model, best), launches = _count(tuner.perform_tuning)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
    finally:
        gp.BayesianOptimizer.ask_session = real
    if sessions:
        fail(f"library: the sequential-fold search opened {len(sessions)} ask session(s)")
    if "CV folds =" in log.text or "fold CV (stacked" in log.text:
        fail("library: the sequential-fold search trained folds on the stacked engine")
    n = tuner.n_units
    folds = kfold_indices(n, LIB_FOLDS, seed=tuner.seed)
    fold_steps = sum(LIB_EPOCHS * (len(tr) // BATCH) for tr, _ in folds)
    retrain_steps = model.train_result.epochs_run * (n // BATCH)
    b1_per_step = B1_PER_STEP * (1 if BATCH <= ROW_TILE else 2)
    want = (b1_per_step * (LIB_SEQ_ITER * fold_steps + retrain_steps),
            B2_PER_FORWARD * LIB_SEQ_ITER * LIB_FOLDS * LIB_EPOCHS, 0)
    if launches != want:
        fail(f"library: the sequential-fold search launched (B1, B2, B3) {launches}, expected "
             f"{want}: {b1_per_step} B1 a step x ({LIB_SEQ_ITER} suggestions x {fold_steps} "
             f"fold steps + {retrain_steps} retrain steps), {B2_PER_FORWARD} B2 a validation")
    if not np.isfinite(model.train_result.history["train_loss"]).all():
        fail("library: the sequential-fold retrain's losses are not finite")
    print(f"library: sequential CV folds ({LIB_SEQ_ITER} suggestions x {LIB_FOLDS} fresh fits "
          f"over {n} samples, folds of {[len(v) for _, v in folds]} validation rows, then the "
          f"full-set retrain) on {DEVICE}: {seconds:.2f} s; launches B1 {launches[0]}, B2 "
          f"{launches[1]}, B3 {launches[2]} (predicted {want}); no ask session; best "
          f"{best}", flush=True)
    return launches, {"seconds": seconds, "launches": launches, "predicted": want}


def stacked_cv(train, workdir: Path) -> tuple:
    """16(b): the CV engine at k = LIB_FOLDS. One stacked step of the
    DirectPred group (K = 12) against each suggestion's own 3-fold round
    (the same rows, and the first step's losses within TOL: trial (s, f)
    starts as fold f of suggestion s alone), then the group's round through
    ``_run_parallel_group_cv`` against each suggestion's
    ``_objective_cv_parallel`` (fold means within ROUND_RTOL), B1 and B2
    launches as its steps and validations predict; a supervised_vae group
    (K = 6) the same way for B3. Returns the launches and summary."""
    import numpy as np
    import torch
    from flexynesis_torch.kernels.fused_linear import ROW_TILE
    from flexynesis_torch.parallel.trials import (
        _gather, _init_stacked, _Round, equal_kfold_indices,
    )

    launches, summary = {}, {}
    k = LIB_FOLDS
    tuner = _lib_tuner(train, "DirectPred", workdir, "lib_cv_directpred", batch_ask=len(LIB_LRS))
    n = tuner.n_units
    tr, va = equal_kfold_indices(n, k, seed=tuner.seed)
    group = [_lib_params(lr) for lr in LIB_LRS]
    model = tuner._get_template(group[0])
    data = model.make_batch(train)

    def first_step(lrs):
        seeds = np.tile(np.arange(tuner.seed, tuner.seed + k), len(lrs))
        params, buffers = _init_stacked(model, seeds)
        r = _Round(model, params, buffers, lrs=np.repeat(lrs, k), seeds=seeds)
        table = r.epoch_rows(np.tile(tr, (len(lrs), 1)), 1, BATCH)[0]
        return table.cpu(), r.step(_gather(data, table)).float().cpu()

    g_table, g_loss = first_step(list(LIB_LRS))
    step_gap = 0.0
    for i, lr in enumerate(LIB_LRS):
        table, loss = first_step([lr])
        own = slice(k * i, k * i + k)
        if not torch.equal(g_table[own], table):
            fail(f"library: the K = {k * len(LIB_LRS)} CV step gives suggestion {i} other rows "
                 "than its own round")
        if not torch.allclose(g_loss[own], loss, **TOL):
            fail(f"library: the K = {k * len(LIB_LRS)} CV step's losses for suggestion {i} "
                 f"{g_loss[own].tolist()} differ from its own round's {loss.tolist()}")
        step_gap = max(step_gap, float(((g_loss[own] - loss) / loss).abs().max()))

    t = time.perf_counter()
    results, launches["cv3_directpred_round"] = _count(lambda: tuner._run_parallel_group_cv(group))
    torch.cuda.synchronize()
    summary["directpred_round_s"] = time.perf_counter() - t
    own_losses = []
    for i, params in enumerate(group):
        (loss, _, _), _ = _count(lambda: tuner._objective_cv_parallel(params, n))
        own_losses.append(loss)
        if not abs(results[i][0] - loss) <= ROUND_RTOL * abs(loss):
            fail(f"library: suggestion {i} scores {results[i][0]} in the K = {k * len(group)} "
                 f"round and {loss} in its own {k}-fold round (rtol {ROUND_RTOL})")
    n_tr = len(tr[0])
    steps = LIB_EPOCHS * (n_tr // BATCH)
    per_call = 1 if BATCH <= ROW_TILE else 2
    want = (B1_PER_STEP * per_call * steps, B2_PER_FORWARD * LIB_EPOCHS, 0)
    if launches["cv3_directpred_round"] != want:
        fail(f"library: the K = {k * len(group)} DirectPred round launched (B1, B2, B3) "
             f"{launches['cv3_directpred_round']}, expected {want} ({steps} stacked steps, "
             f"{LIB_EPOCHS} stacked validations)")
    gap = max(abs(a[0] - b) / abs(b) for a, b in zip(results, own_losses))
    print(f"library: DirectPred CV round of {len(group)} suggestions x {k} folds (K = "
          f"{k * len(group)}, {n_tr} training and {len(va[0])} validation rows a fold) in "
          f"{summary['directpred_round_s']:.2f} s: first step's losses within {step_gap:.2e} "
          f"(relative) of each suggestion's own round, the same rows; fold means "
          f"{[round(r[0], 5) for r in results]} against its own rounds' "
          f"{[round(v, 5) for v in own_losses]} ({gap:.2e} apart); launches "
          f"{launches['cv3_directpred_round']} (predicted {want})", flush=True)

    vae = _lib_tuner(train, "supervised_vae", workdir, "lib_cv_vae", batch_ask=len(LIB_VAE_LRS))
    vae_group = [_lib_params(lr) for lr in LIB_VAE_LRS]
    t = time.perf_counter()
    vae_results, launches["cv3_vae_round"] = _count(lambda: vae._run_parallel_group_cv(vae_group))
    torch.cuda.synchronize()
    summary["vae_round_s"] = time.perf_counter() - t
    n_dec = len(train.dat)
    vae_want = (0, 0, n_dec * (steps + LIB_EPOCHS))
    if launches["cv3_vae_round"] != vae_want:
        fail(f"library: the K = {k * len(vae_group)} supervised_vae round launched (B1, B2, B3) "
             f"{launches['cv3_vae_round']}, expected {vae_want} ({n_dec} decoded layers x "
             f"({steps} stacked steps + {LIB_EPOCHS} stacked validations))")
    if not all(np.isfinite(r[0]) for r in vae_results):
        fail(f"library: the supervised_vae CV round scored {vae_results}")
    print(f"library: supervised_vae CV round of {len(vae_group)} x {k} (K = "
          f"{k * len(vae_group)}) in {summary['vae_round_s']:.2f} s: fold means "
          f"{[round(r[0], 5) for r in vae_results]}; launches {launches['cv3_vae_round']} "
          f"(predicted {vae_want})", flush=True)
    summary.update(step_rel_gap=step_gap, round_rel_gap=gap, launches=launches,
                   validation_rows=len(va[0]))
    return launches, summary


def check_cv3_kernels(val_rows: int) -> list:
    """16(b): B1 and B2 at the K = 12 round's shapes (x per trial: each
    trial gathers its fold's rows), B3's MMD term at the K = 6 round's (a
    prior per trial), against their plain versions."""
    K, K_vae = LIB_FOLDS * len(LIB_LRS), LIB_FOLDS * len(LIB_VAE_LRS)
    cases = [("B1", f"cv{K}_{name}_x_per_trial", K, BATCH, F, H, True)
             for name, F, H in trial_blocks()]
    cases += [("B2", f"cv{K}_{name}_val{val_rows}", K, val_rows, F, H, True)
              for name, F, H in trial_blocks()]
    rows = check_trial_kernels(cases)
    b3 = check_b3_trials([(f"cv{K_vae}_train_per_trial", K_vae, 200, BATCH, LATENT, True),
                          (f"cv{K_vae}_val{val_rows}_per_trial", K_vae, 200, val_rows, LATENT,
                           True)])
    return rows + [dict(r, kernel="B3") for r in b3]


def laplacian_phase(workdir: Path) -> dict:
    """16(c): the Laplacian score of phase 5's raw training gex matrix (2000
    samples x 4000 features, a missing cell set to its feature's median as
    the importer's cleanup sets it): the heat-kernel score (t = twice the
    summed feature variances, the mean squared distance between two samples)
    on the card against the CPU, and the kNN score sharded over two shards
    of the card (``laplacian_score_sharded``) against the unsharded one,
    each within LAPLACIAN_TOL; synchronised seconds of each (the card's
    after one warm-up call). The kNN score card against CPU is held too
    unless some sample's k-th and (k+1)-th neighbours lie within twice
    float32's largest error in d^2 (both measured here against float64 on
    the card): then the two devices' sums may pick different neighbours, as
    they would for the JAX package, and the gap is printed, not held."""
    import numpy as np
    import torch
    from flexynesis_torch.data.fastcsv import read_matrix_csv
    from flexynesis_torch.data.feature_selection import laplacian_score, laplacian_score_sharded
    from flexynesis_torch.parallel.mesh import get_mesh

    _, _, mat = read_matrix_csv(str(workdir / "fit_data" / "train" / "gex.csv"))
    with np.errstate(all="ignore"):
        med = np.nanmedian(mat.astype(np.float64), axis=1, keepdims=True)
    X = np.ascontiguousarray(np.where(np.isnan(mat), med, mat).T, dtype=np.float32)
    t_heat = float(2 * X.astype(np.float64).var(axis=0).sum())
    mesh = get_mesh((("data", len(MESH_DEVICES)),), devices=MESH_DEVICES)

    def run(fn, warm: bool):
        if warm:
            fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    Xd = torch.from_numpy(X).to(DEVICE)
    X64 = Xd.double()
    sq32, sq64 = (Xd * Xd).sum(dim=1), (X64 * X64).sum(dim=1)
    d64 = sq64[:, None] + sq64[None, :] - 2.0 * (X64 @ X64.T)
    d2_err = float(((sq32[:, None] + sq32[None, :] - 2.0 * (Xd @ Xd.T)).double() - d64)
                   .abs().max())
    d64.fill_diagonal_(-1.0)  # self is one of the k, as in the score
    nearest = -torch.topk(-d64, LAPLACIAN_K + 1, dim=1).values
    near_ties = int((nearest[:, LAPLACIAN_K] - nearest[:, LAPLACIAN_K - 1] <= 2 * d2_err).sum())
    del Xd, X64, d64

    scores, seconds = {}, {}
    calls = {
        "heat_card": (lambda: laplacian_score(X, LAPLACIAN_K, t=t_heat, device=DEVICE), True),
        "heat_cpu": (lambda: laplacian_score(X, LAPLACIAN_K, t=t_heat, device="cpu"), False),
        "knn_card": (lambda: laplacian_score(X, LAPLACIAN_K, device=DEVICE), True),
        "knn_cpu": (lambda: laplacian_score(X, LAPLACIAN_K, device="cpu"), False),
        "knn_sharded_card": (lambda: laplacian_score_sharded(X, LAPLACIAN_K, mesh=mesh), True),
    }
    for name, (fn, warm) in calls.items():
        scores[name], seconds[name] = run(fn, warm)
        if scores[name].shape != (X.shape[1],) or not np.isfinite(scores[name]).all():
            fail(f"library: the {name} Laplacian scores are not {X.shape[1]} finite values")
    gaps = {}
    for got, want in (("heat_card", "heat_cpu"), ("knn_sharded_card", "knn_card"),
                      ("knn_card", "knn_cpu")):
        a, b = scores[got], scores[want]
        gaps[f"{got}_vs_{want}"] = float(np.abs(a - b).max())
        if (want != "knn_cpu" or not near_ties) and not np.allclose(a, b, **LAPLACIAN_TOL):
            fail(f"library: the {got} Laplacian scores differ from the {want} ones: max abs "
                 f"{gaps[f'{got}_vs_{want}']:.3e}, tolerance {LAPLACIAN_TOL}")
    beyond = int((~np.isclose(scores["knn_card"], scores["knn_cpu"], **LAPLACIAN_TOL)).sum())
    print(f"library: Laplacian scores of {X.shape[0]} samples x {X.shape[1]} features (k "
          f"{LAPLACIAN_K}; heat kernel t = {t_heat:.1f}): the heat kernel card against CPU "
          f"and the kNN score sharded over {len(MESH_DEVICES)} shards of {MESH_DEVICES[0]} "
          f"against unsharded held; {near_ties} samples whose {LAPLACIAN_K}th and "
          f"{LAPLACIAN_K + 1}th neighbours lie within 2 x {d2_err:.3e} (float32's largest "
          f"error in d^2) of each other, so the kNN score card against CPU "
          + ("is held" if not near_ties else
             f"is not held ({beyond} features beyond the tolerance)")
          + "; max abs gaps "
          f"{json.dumps({k: float(f'{v:.3e}') for k, v in gaps.items()})} (tol {LAPLACIAN_TOL});"
          f" seconds {json.dumps({k: round(v, 4) for k, v in seconds.items()})}", flush=True)
    return {"seconds": seconds, "max_abs_gaps": gaps, "t": t_heat,
            "knn_cpu_features_beyond_tol": beyond, "near_tied_samples": near_ties,
            "d2_f32_max_abs_err": d2_err}


def facade_check() -> dict:
    """16(d): every name of the ``data``, ``ops``, ``train`` and ``models``
    facades resolves to an object of the port, and nothing of JAX is
    loaded."""
    import importlib

    names = {}
    for pkg in ("data", "ops", "train", "models"):
        mod = importlib.import_module(f"flexynesis_torch.{pkg}")
        for name in mod.__all__:
            value = getattr(mod, name)
            home = (next(iter(value.values())).__module__ if name == "MODEL_REGISTRY"
                    else value.__module__)
            if not home.startswith("flexynesis_torch."):
                fail(f"library: flexynesis_torch.{pkg}.{name} resolves to {home}")
        names[pkg] = len(mod.__all__)
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "flax", "flexynesis_tpu"))
    if loaded:
        fail(f"library: the port loaded {loaded}")
    print(f"library: facades resolve every name to the port ({names}); no JAX module loaded",
          flush=True)
    return names


def library_phase(workdir: Path, importer_cache: "ImportOnce") -> tuple:
    """Phase 16: the tuner's and feature selection's options the CLI never
    sets, on phase 5's folder and import (after phase 15): (a) sequential
    CV folds, (b) the stacked CV engine at k = 3 with B1, B2 and B3 at its
    shapes, (c) the heat-kernel and feature-sharded Laplacian scores, (d)
    the facades. Returns the launches, the summary and the kernel rows."""
    t0 = time.perf_counter()
    train = phase5_training_set(importer_cache, workdir, "library")
    launches, summary = {}, {}
    launches["cv3_sequential"], summary["sequential"] = sequential_folds(train, workdir)
    rows = check_cv3_kernels(len(train) // LIB_FOLDS)
    cv_launches, summary["stacked_cv"] = stacked_cv(train, workdir)
    launches.update(cv_launches)
    summary["laplacian"] = laplacian_phase(workdir)
    summary["facades"] = facade_check()
    summary["seconds"] = time.perf_counter() - t0
    print(f"library: phase 16 in {summary['seconds']:.1f} s", flush=True)
    return launches, summary, rows


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


def grid_entry(rows, kind: str):
    """The fine-tuning grid's trial axis in the kernels line: one stacked
    step (B1) or validation (B2) of FT_K trials over the early-fusion path's
    two blocks, x per trial."""
    return axis_entry(rows, kind, FT_K, ("grid_all", "grid_head"))


def axis_entry(rows, kind: str, K: int, label_parts):
    """One stacked pass of K trials of B1 or B2 in the kernels line: the
    rows of that K whose label holds one of ``label_parts``, summed."""
    path = [r for r in rows if r["kernel"] == kind and r["K"] == K
            and any(part in r["label"] for part in label_parts)]
    bms, by = bound_ms(sum(r["ops_ms"] for r in path), sum(r["bytes"] for r in path))
    return {"K": K, "launches_per_pass": sum(r["launches"] for r in path),
            "ms": sum(r["ms"] for r in path),
            "device_ms": (None if any(r["device_ms"] is None for r in path)
                          else sum(r["device_ms"] for r in path)),
            "host_ms": sum(r["host_ms"] for r in path),
            "plain_ms": sum(r["plain_ms"] for r in path), "bound_ms": bms, "bound_by": by,
            "shapes": [[r["K"], r["B"], r["F"], r["H"]] for r in path]}


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
    build_all(["fused_linear_eval", "fused_linear_train", "mmd_kernel", "sr_adam", "fastcsv"])

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
    seconds = {}

    def timed(name, fn, *args):
        """``fn(*args)``, its host-clock seconds printed and kept in ``seconds``."""
        t = time.perf_counter()
        out = fn(*args)
        seconds[name] = round(time.perf_counter() - t, 1)
        print(f"phase {name}: {seconds[name]} s", flush=True)
        return out

    train_shapes, rows, passes, b1_rows, b3_rows, term_rows, trial_rows = timed(
        "kernels", check_kernels)

    workdir = REPO / "build" / "chip_smoke"
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    serve_b2 = timed("serving", serve, workdir)
    importer_cache = ImportOnce()
    with importer_cache:  # phase 5 imports its folder once for the trial phase too
        (train_b1, train_b2), b2_train_rows, cohort = timed("training", train, workdir)
    # B2 at the shapes the training phase gave it that serving did not
    checked = {(r["B"], r["F"], r["H"]) for r in rows}
    rows += timed("b2_training_shapes", check_kernel,
                  [(f"{n}_n{B}", (B, F, H)) for B in b2_train_rows
                   for n, (F, H) in b2_blocks() if (B, F, H) not in checked])
    hpo_launches, hpo_summary = timed("trials", train_trials, workdir, importer_cache, cohort)
    vae_launches, vae_summary = timed("vae_trials", vae_trials, workdir, importer_cache, cohort)
    vae_b3 = timed("supervised_vae", train_vae, workdir, "supervised_vae", FIT_EPOCHS)
    cm_b3 = timed("crossmodal", train_vae, workdir, "CrossModalPred", CM_EPOCHS,
                  ("--input_layers", "gex", "--output_layers", "cnv"), False)
    marker_summary = timed("markers", markers, workdir)
    marker_b1, marker_b2, marker_b3 = marker_summary.pop("launches")
    triplet_launches, triplet_summary = timed("triplet", triplet, workdir, importer_cache,
                                              cohort)
    gnn_launches, gnn_summary = timed("gnn", gnn, workdir, importer_cache)
    zoo = {**triplet_launches, **gnn_launches}
    ft_b1_rows, ft_b2_rows, ft_trial_rows = timed("finetune_kernels", check_finetune_kernels)
    ft_launches, ft_summary = timed("finetune", finetune_phase, workdir, importer_cache)
    trial_rows += ft_trial_rows
    h5_launches, h5_summary = timed("h5", h5_phase, workdir, (train_b1, train_b2))
    base_launches, base_summary = timed("baselines", baseline_phase, workdir, importer_cache)
    analysis_launches, analysis_summary = timed("analysis", analysis_phase, workdir)
    mesh_launches, mesh_summary = timed("mesh", mesh_phase, cohort)
    joblib_launches, joblib_summary = timed("joblib", joblib_phase, workdir, importer_cache)
    lib_launches, lib_summary, lib_rows = timed("library", library_phase, workdir,
                                                importer_cache)
    trial_rows += lib_rows
    ft_launches = {**ft_launches, **h5_launches, **base_launches, **analysis_launches,
                   **mesh_launches, **joblib_launches, **lib_launches}
    K_cv3, K_cv3_vae = LIB_FOLDS * len(LIB_LRS), LIB_FOLDS * len(LIB_VAE_LRS)

    trial_b1 = [r for r in trial_rows if r["kernel"] == "B1"]
    trial_b2 = [r for r in trial_rows if r["kernel"] == "B2"]
    trial_b3 = [r for r in trial_rows if r["kernel"] == "B3"]
    entries = [
        kernel_entry("fused_linear_bn_relu", "flexynesis_torch/csrc/fused_linear_train.cu",
                     "flexynesis_tpu/ops/pallas/fused_linear.py:115",
                     b1_rows + ft_b1_rows + trial_b1,
                     b1_rows[:len(train_shapes)],  # one training forward
                     train_b1, {"training": train_b1,
                                **{k: v[0] for k, v in {**hpo_launches, **vae_launches}.items()},
                                "default_directpred_markers": marker_b1,
                                **{k: v[0] for k, v in zoo.items()},
                                **{k: v[0] for k, v in ft_launches.items()}},
                     extra={"trial_axis": trial_entry(trial_b1, "shared_x"),
                            "finetune_grid_axis": grid_entry(trial_b1, "B1"),
                            "cv3_axis": axis_entry(trial_b1, "B1", K_cv3, ("_x_per_trial",))}),
        kernel_entry("fused_linear_bn_relu_eval", "flexynesis_torch/csrc/fused_linear_eval.cu",
                     "flexynesis_tpu/ops/pallas/fused_linear.py:223",
                     rows + ft_b2_rows + trial_b2,
                     rows[:len(b2_blocks())],  # one eval forward over the cohort
                     serve_b2, {"serving": serve_b2, "training": train_b2,
                                **{k: v[1] for k, v in {**hpo_launches, **vae_launches}.items()},
                                "default_directpred_markers": marker_b2,
                                **{k: v[1] for k, v in zoo.items()},
                                **{k: v[1] for k, v in ft_launches.items()}},
                     extra={"gemm_only_addmm_device_ms": passes["cohort"]["addmm_device_ms"],
                            "passes": passes, "trial_axis": trial_entry(trial_b2, "_val"),
                            "finetune_grid_axis": grid_entry(trial_b2, "B2"),
                            "cv3_axis": axis_entry(trial_b2, "B2", K_cv3, ("_val",))}),
        kernel_entry("gaussian_kernel_mean", "flexynesis_torch/csrc/mmd_kernel.cu",
                     "flexynesis_tpu/ops/pallas/mmd_kernel.py:66", b3_rows + term_rows + trial_b3,
                     term_rows[:1], vae_b3,
                     {"supervised_vae_training": vae_b3, "crossmodal_training": cm_b3,
                      **{k: v[2] for k, v in {**hpo_launches, **vae_launches}.items()},
                      "default_directpred_markers": marker_b3,
                      **{k: v[2] for k, v in zoo.items()},
                      **{k: v[2] for k, v in ft_launches.items()}},
                     per_path=2,  # one training step: an MMD term per decoded layer
                     extra={"trial_axis": b3_trial_entry(
                         [r for r in trial_b3 if not r["label"].startswith("cv")]),
                            "cv3_axis": [{k: r[k] for k in ("label", "shape", "ms", "device_ms",
                                                            "plain_ms", "bound_ms", "bound_by",
                                                            "max_abs_err")}
                                         for r in trial_b3 if r["K"] == K_cv3_vae]}),
    ]
    entries.append(sr_adam_entry(hpo_summary.pop("sr_adam"), dict(SR_LAUNCHES)))
    print("trials: summary " + json.dumps(hpo_summary), flush=True)
    print("vae trials: summary " + json.dumps(vae_summary), flush=True)
    print("markers: summary " + json.dumps(marker_summary), flush=True)
    print("triplet: summary " + json.dumps(triplet_summary), flush=True)
    print("gnn: summary " + json.dumps(gnn_summary), flush=True)
    print("finetune: summary " + json.dumps(ft_summary), flush=True)
    print("h5: summary " + json.dumps(h5_summary), flush=True)
    print("baselines: summary " + json.dumps(base_summary), flush=True)
    print("analysis: summary " + json.dumps(analysis_summary, default=float), flush=True)
    print("mesh: summary " + json.dumps(mesh_summary, default=float), flush=True)
    print("joblib: summary " + json.dumps(joblib_summary, default=float), flush=True)
    print("library: summary " + json.dumps(lib_summary, default=float), flush=True)
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s", flush=True)
    print("phase seconds: " + json.dumps(seconds), flush=True)
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
