"""Drive flexynesis_torch on one CUDA card and check it end to end.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure exits nonzero):
1. the card's name and power limit; build kernels B1 and B2 with nvcc for
   sm_90a, one nvcc per source, started together;
2. kernel B2 (eval-mode fused Linear->BN->ReLU) against its plain PyTorch
   version at every shape the serving phase launches, a ragged shape and the
   production single-model encoder, with CUDA-event timings of the kernel,
   the plain version and torch.addmm (a GEMM-only yardstick), and each
   shape's bound on an H100;
3. kernel B1 (training-mode, batch statistics) the same way at every shape
   the training phase launches, 32- and 128-row batches, a ragged shape,
   B = 1 and a 4096-row batch (the split reduction); its gradients
   (kernel forward + the JAX backward formula) against autograd through the
   plain version at the three training shapes;
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
   cohorts) that serving did not.

Each kernel's launch count is set to 0 just before the phase that drives its
path (serving for B2, training for B1) and read just after. The output ends
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

# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
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
DEVICE = "cuda"  # the training phase's device (a CPU rehearsal sets "cpu")


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


def work(B: int, F: int, H: int):
    """(FLOPs, bytes) the fused block needs: the GEMM plus a 6-op epilogue per
    output; each input read once and the output written once, in f32."""
    return 2 * B * F * H + 6 * B * H, 4 * (B * F + F * H + 5 * H + B * H)


def bound_ms(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def check_kernel(shapes):
    """Hold B2 against its plain version at each shape; returns per-shape rows."""
    import torch
    from flexynesis_torch.kernels.fused_linear import (
        fused_linear_bn_relu_eval as kernel,
        fused_linear_bn_relu_eval_ref as plain,
    )

    rows = []
    for label, (B, F, H) in shapes:
        g = torch.Generator(device="cuda").manual_seed(B * 7 + F * 3 + H)
        x = torch.randn(B, F, device="cuda", generator=g)
        w = (torch.rand(F, H, device="cuda", generator=g) * 2 - 1) / math.sqrt(F)
        b, rm, be = (torch.randn(H, device="cuda", generator=g) * 0.1 for _ in range(3))
        gamma = torch.rand(H, device="cuda", generator=g) + 0.5
        rv = torch.rand(H, device="cuda", generator=g) + 0.5
        args = (x, w, b, gamma, be, rm, rv)
        y = kernel(*args)
        torch.cuda.synchronize()
        ref = plain(*args)
        diff = (y - ref).abs()
        max_abs = diff.max().item()
        max_rel = max_abs / ref.abs().max().item()  # normwise: against the largest output
        if not torch.allclose(y, ref, **TOL):
            fail(f"B2 disagrees with its plain version at {label} B={B} F={F} H={H}: "
                 f"max abs {max_abs:.3e}, max rel {max_rel:.3e}, tolerance {TOL}")
        reps = 10 if B * F * H > 1e10 else 30
        ms = cuda_ms(lambda: kernel(*args), reps)
        plain_ms = cuda_ms(lambda: plain(*args), reps)
        addmm_ms = cuda_ms(lambda: torch.addmm(b, x, w), reps)
        flops, nbytes = work(B, F, H)
        bms, by = bound_ms(flops, nbytes)
        rows.append(dict(label=label, B=B, F=F, H=H, max_abs_err=max_abs,
                         max_rel_err=max_rel, ms=ms, plain_ms=plain_ms,
                         addmm_ms=addmm_ms, flops=flops, bytes=nbytes,
                         bound_ms=bms, bound_by=by))
        print(f"B2 {label:>16} B={B:5d} F={F:6d} H={H:5d}  max_abs_err={max_abs:.3e} "
              f"normwise_rel_err={max_rel:.3e} (tol {TOL})  kernel {ms:.4f} ms  "
              f"plain {plain_ms:.4f} ms  addmm(GEMM only) {addmm_ms:.4f} ms  "
              f"bound {bms:.4f} ms ({by})  {flops / ms / 1e9:.2f} TFLOP/s", flush=True)
    return rows


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
    )

    rows = []
    for label, (B, F, H) in shapes:
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
        plain_ms = cuda_ms(lambda: plain(*args), reps)
        addmm_ms = cuda_ms(lambda: torch.addmm(b, x, w), reps)
        flops, nbytes = work_b1(B, F, H)
        bms, by = bound_ms(flops, nbytes)
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
        rows.append(dict(label=label, B=B, F=F, H=H, max_abs_err=max_abs,
                         grad_max_abs_err=grad_err, ms=ms, plain_ms=plain_ms,
                         addmm_ms=addmm_ms, flops=flops, bytes=nbytes,
                         bound_ms=bms, bound_by=by))
        print(f"B1 {label:>16} B={B:5d} F={F:6d} H={H:5d}  max_abs_err={max_abs:.3e} "
              f"grad_max_abs_err={'n/a' if grad_err is None else f'{grad_err:.3e}'} "
              f"(tol {TOL})  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
              f"addmm(GEMM only) {addmm_ms:.4f} ms  bound {bms:.4f} ms ({by})  "
              f"{flops / ms / 1e9:.2f} TFLOP/s", flush=True)
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


HPO_CONFIG = """DirectPred:
  - {type: Categorical, categories: [%d], name: latent_dim}
  - {type: Categorical, categories: [%s], name: hidden_dim_factor}
  - {type: Categorical, categories: [0.001], name: lr}
  - {type: Categorical, categories: [%d], name: supervisor_hidden_dim}
  - {type: Categorical, categories: [%d], name: epochs}
  - {type: Categorical, categories: [%d], name: batch_size}
  - {type: Categorical, categories: [true], name: fused_kernels}
"""


def train_args(data: Path, config: Path, outdir: Path, device: str):
    return ["--data_path", str(data), "--model_class", "DirectPred",
            "--data_types", "gex,cnv", "--target_variables", "subtype",
            "--config_path", str(config), "--hpo_iter", "1",
            "--features_top_percentile", str(TOP_PERCENTILE), "--variance_threshold", "0",
            "--features_min", str(FEATURES_MIN),
            "--safetensors", "--disable_marker_finding", "--device", device,
            "--outdir", str(outdir), "--prefix", "fit"]


def check_card_matches_cpu(model, cohort):
    """Three training steps from one initialisation with dropout 0 and one
    permutation, on the card and on the CPU: per-step losses and the first
    step's gradients must agree."""
    import torch
    from flexynesis_torch.models.direct_pred import DirectPred
    from flexynesis_torch.ops.fused_mlp import FusedMLP
    from flexynesis_torch.train.trainer import Trainer, gather

    runs = {}
    for device in (DEVICE, "cpu"):
        m = DirectPred(model.config, cohort, target_variables=["subtype"], device=device)
        m.init_params(seed=3)
        for block in m.module.modules():
            if isinstance(block, FusedMLP):
                block.dropout_rate = 0.0
        data = m.make_batch(cohort)
        perm = torch.randperm(len(cohort), generator=torch.Generator().manual_seed(5))
        perm = perm[: 3 * BATCH].reshape(3, BATCH).to(device)
        trainer = Trainer(m.module, m.loss_fn, lr=float(model.config["lr"]))
        gen = torch.Generator(device=device)
        total, _ = m.loss_fn(gather(data, perm[0]), gen, True)
        grads = torch.autograd.grad(total, trainer.params, allow_unused=True)
        trainer.optimizer.step(grads)
        losses = [float(total.detach())] + [float(trainer.train_step(gather(data, p), gen))
                                            for p in perm[1:]]
        runs[device] = (losses, [None if g is None else g.cpu() for g in grads])
    (l_gpu, g_gpu), (l_cpu, g_cpu) = runs[DEVICE], runs["cpu"]
    if not all(math.isclose(a, b, rel_tol=1e-4) for a, b in zip(l_gpu, l_cpu)):
        fail(f"training steps disagree between cuda and cpu: {l_gpu} vs {l_cpu}")
    grad_err = 0.0
    for a, b in zip(g_gpu, g_cpu):
        if a is None:
            continue
        grad_err = max(grad_err, float((a - b).abs().max()))
        if not torch.allclose(a, b, rtol=1e-4, atol=1e-4):
            fail(f"first-step gradients disagree between cuda and cpu: {grad_err:.3e}")
    print(f"training: 3 steps cuda vs cpu, losses {l_gpu} vs {l_cpu} (rtol 1e-4); "
          f"first-step gradients max abs diff {grad_err:.3e} (rtol/atol 1e-4)", flush=True)


def time_steps(model, cohort):
    """Median host-clock time of one training step (synchronised), and a
    profiled run of PROFILED_STEPS steps with its device-busy share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from flexynesis_torch.train.trainer import Trainer, gather

    data = model.make_batch(cohort)
    trainer = Trainer(model.module, model.loss_fn, lr=float(model.config["lr"]))
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    perm = torch.randperm(len(cohort), generator=torch.Generator().manual_seed(9))
    batches = [gather(data, perm[i:i + BATCH].to(DEVICE))
               for i in range(0, len(cohort) - BATCH + 1, BATCH)]
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
    print(f"training: train step (batch {BATCH}) x30: median {med * 1e3:.3f} ms "
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
        print(f"training: profiled {PROFILED_STEPS} steps: wall {wall_us:.0f} us, device busy "
              f"{busy_us:.0f} us ({100 * busy_us / wall_us:.1f}%), {per_step:.0f} device "
              "operations per step; top: "
              + "; ".join(f"{e.key[:48]} {e.self_device_time_total:.0f} us" for e in top),
              flush=True)
    else:
        print("training: profiled steps: the profiler saw no device time (not measured)")
    return med


def train(workdir: Path):
    """The training phase; returns (B1 launches, B2 launches) of the CLI run
    and the batch sizes the run gave B2 (validation, train and test cohorts)."""
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
    config.write_text(HPO_CONFIG % (LATENT, HIDDEN_FACTOR, SUP_HIDDEN, FIT_EPOCHS, BATCH))
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
    return launches, b2_rows


def build_all(names):
    """Build the kernels' libraries, one nvcc per source, started together."""
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


def kernel_entry(name, source, replaces, rows, path_rows, launches, by_path):
    flops = sum(r["flops"] for r in path_rows)
    nbytes = sum(r["bytes"] for r in path_rows)
    bms, by = bound_ms(flops, nbytes)
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches,
        "launches_by_path": by_path,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": sum(r["ms"] for r in path_rows),
        "plain_ms": sum(r["plain_ms"] for r in path_rows),
        "bound_ms": bms,
        "bound_by": by,
        "library_ms": None,
        "gemm_only_addmm_ms": sum(r["addmm_ms"] for r in path_rows),
        "shapes": [[r["B"], r["F"], r["H"]] for r in path_rows],
    }


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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    build_all(["fused_linear_eval", "fused_linear_train"])

    h_gex, h_cnv = int(GEX * HIDDEN_FACTOR), int(CNV * HIDDEN_FACTOR)
    serving_shapes = [
        ("encoder_gex", (N_TEST, GEX, h_gex)),
        ("encoder_cnv", (N_TEST, CNV, h_cnv)),
        ("head_subtype", (N_TEST, LATENT, SUP_HIDDEN)),
    ]
    request_shapes = [(f"{n}_b{BATCH}", (BATCH, F, H)) for n, (_, F, H) in serving_shapes]
    extra_shapes = [("ragged", (37, 129, 67)),
                    ("large_encoder", (1024, 16384, int(16384 * 0.3)))]
    rows = check_kernel(serving_shapes + request_shapes + extra_shapes)

    train_shapes = [
        ("encoder_gex", (BATCH, GEX, h_gex)),
        ("encoder_cnv", (BATCH, CNV, h_cnv)),
        ("head_subtype", (BATCH, LATENT, SUP_HIDDEN)),
    ]
    b1_extra = [("encoder_gex_b32", (32, GEX, h_gex)), ("encoder_gex_b128", (128, GEX, h_gex)),
                ("ragged", (37, 129, 67)), ("one_row", (1, LATENT, SUP_HIDDEN)),
                ("split_b4096", (4096, GEX, h_gex))]
    b1_rows = check_b1(train_shapes + b1_extra, [shape for _, shape in train_shapes])

    workdir = REPO / "build" / "chip_smoke"
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    serve_b2 = serve(workdir)
    (train_b1, train_b2), b2_train_rows = train(workdir)
    # B2 at the shapes the training phase gave it that serving did not
    checked = {(r["B"], r["F"], r["H"]) for r in rows}
    rows += check_kernel([(f"{n}_n{B}", (B, F, H)) for B in b2_train_rows
                          for n, (_, F, H) in serving_shapes if (B, F, H) not in checked])

    entries = [
        kernel_entry("fused_linear_bn_relu", "flexynesis_torch/csrc/fused_linear_train.cu",
                     "flexynesis_tpu/ops/pallas/fused_linear.py:115", b1_rows,
                     b1_rows[:len(train_shapes)],  # one training forward
                     train_b1, {"training": train_b1}),
        kernel_entry("fused_linear_bn_relu_eval", "flexynesis_torch/csrc/fused_linear_eval.cu",
                     "flexynesis_tpu/ops/pallas/fused_linear.py:223", rows,
                     rows[:len(serving_shapes)],  # one eval forward over the cohort
                     serve_b2, {"serving": serve_b2, "training": train_b2}),
    ]
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
