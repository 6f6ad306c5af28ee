"""Drive flexynesis_torch on one CUDA card and check it end to end.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure exits nonzero):
1. the card's name and power limit; build kernel B2 with nvcc for sm_90a;
2. kernel B2 against its plain PyTorch version at every shape the serving
   phase launches, a ragged shape and the production single-model encoder,
   with CUDA-event timings of the kernel, the plain version and torch.addmm
   (a GEMM-only yardstick), and each shape's bound on an H100;
3. serving at full width: the DirectPred headline configuration (gex 2000 and
   cnv 1000 features, hidden widths 600 and 300, latent 64, supervisor hidden
   16, 4 classes, fused_kernels on) scores a 2000-sample cohort through
   ``python -m flexynesis_torch``'s inference mode on the card, once more on
   the CPU as the reference, then answers timed requests.

The output ends with a ``{"kernels": [...]}`` line, the nvidia-smi line and
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


def read_outputs(outdir: Path):
    """(samples, embeddings, probabilities, stats rows), checked for shape and finiteness."""
    import numpy as np
    from flexynesis_torch.utils.csvio import read_matrix, read_table

    samples, _, emb = read_matrix(str(outdir / "smoke.embeddings_test.csv"))
    if emb.shape != (N_TEST, LATENT) or not np.isfinite(emb).all():
        fail(f"embeddings: shape {emb.shape}, finite {np.isfinite(emb).all()}")
    _, columns, rows = read_table(str(outdir / "smoke.predicted_labels.csv"))
    prob = np.array([float(r[columns.index("probability")]) for r in rows])
    if prob.size != N_TEST * N_CLASSES or not np.isfinite(prob).all():
        fail(f"predicted_labels: {prob.size} probabilities")
    sums = prob.reshape(N_TEST, N_CLASSES).sum(axis=1)
    if not np.allclose(sums, 1.0, atol=1e-5):
        fail("predicted probabilities do not sum to one")
    _, stat_cols, stat_rows = read_table(str(outdir / "smoke.stats.csv"))
    values = [float(r[stat_cols.index("value")]) for r in stat_rows
              if r[stat_cols.index("value")] != ""]
    if not values or not np.isfinite(values).all():
        fail(f"stats.csv holds no finite metric: {stat_rows}")
    return samples, emb, prob, stat_rows


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
    s_gpu, emb_gpu, p_gpu, stats = read_outputs(workdir / "out_cuda")
    s_cpu, emb_cpu, p_cpu, _ = read_outputs(workdir / "out_cpu")
    if s_gpu != s_cpu:
        fail("the cuda and cpu runs scored different samples")
    emb_err = float(np.abs(emb_gpu - emb_cpu).max())
    p_err = float(np.abs(p_gpu - p_cpu).max())
    if not (np.allclose(emb_gpu, emb_cpu, **TOL) and np.allclose(p_gpu, p_cpu, **TOL)):
        fail(f"cuda and cpu outputs differ: embeddings {emb_err:.3e}, probabilities {p_err:.3e}")
    print(f"serving: cuda vs cpu max abs diff: embeddings {emb_err:.3e}, "
          f"probabilities {p_err:.3e} (tol {TOL})", flush=True)
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if not (REPO / "flexynesis_torch" / "csrc").is_dir():
        print(f"chip_smoke: {REPO} holds no flexynesis_torch checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from flexynesis_torch.kernels import build

    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    lib = build.build("fused_linear_eval")
    print(f"build: {lib.name} in {time.perf_counter() - t0:.2f} s", flush=True)
    log = lib.with_suffix(".log")
    if log.exists():
        print(log.read_text().strip(), flush=True)

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

    workdir = REPO / "build" / "chip_smoke"
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    launches = serve(workdir)

    path_rows = rows[:len(serving_shapes)]  # one eval forward over the cohort
    flops = sum(r["flops"] for r in path_rows)
    nbytes = sum(r["bytes"] for r in path_rows)
    bms, by = bound_ms(flops, nbytes)
    entry = {
        "name": "fused_linear_bn_relu_eval",
        "route": "cuda",
        "source": "flexynesis_torch/csrc/fused_linear_eval.cu",
        "replaces": "flexynesis_tpu/ops/pallas/fused_linear.py:223",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": sum(r["ms"] for r in path_rows),
        "plain_ms": sum(r["plain_ms"] for r in path_rows),
        "bound_ms": bms,
        "bound_by": by,
        "library_ms": None,
        "gemm_only_addmm_ms": sum(r["addmm_ms"] for r in path_rows),
        "shapes": [[r["B"], r["F"], r["H"]] for r in path_rows],
    }
    print(json.dumps({"kernels": [entry]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
