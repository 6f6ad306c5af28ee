"""The port's classical baselines on the card, beyond what ``chip_smoke.py``
checks, on phase 12's reduced folder (300 + 100 samples, 4-class
``subtype`` and ``age``, gex 400 + cnv 200 raw features selected to
200 + 100):

* each RandomForest and XGBoost grid (5 folds, the full grids of
  ``utils/baselines.py``) timed with the batched ``grid_scores`` (the
  folds and nested candidates of a grid fitted side by side) and with one
  fit per candidate and fold, and the chosen candidates compared;
* the SVM grid's tables on the card against the CPU's, with the kernel
  matrix in float64 (as the port computes it), in float32, and in float32
  with TF32 products: the spread that a card-against-CPU tolerance must
  tell apart;
* a GradientBoosting classifier (50 stages, depth 6), card against CPU, on
  the training rows and on the held-out rows.

Prints the card's name and power limit, then one JSON object (also written
to ``--out``). Needs one CUDA card.

Usage: python tools/measure_port_baselines.py [--out chiprun_out/port_baselines.json]
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from flexynesis_torch.data.importer import DataImporter  # noqa: E402
from flexynesis_torch.utils import baselines  # noqa: E402
from flexynesis_torch.utils.classical import GridSearchCV, KFold, svm  # noqa: E402
from flexynesis_torch.utils.synthetic import write_synthetic_folder  # noqa: E402

TRAIN, TEST, RAW, CLASSES = 300, 100, {"gex": 400, "cnv": 200}, 4  # chip_smoke.py, phase 12
GB = {"n_estimators": 50, "max_depth": 6, "learning_rate": 0.1}
DEVICE = "cuda"  # the side measured against the CPU


def reduced_folder(root: str):
    write_synthetic_folder(root, n_train=TRAIN, n_test=TEST, n_features=RAW,
                           n_classes=CLASSES, seed=2)
    return DataImporter(root, ["gex", "cnv"], top_percentile=50, min_features=50,
                        variance_threshold=0.0, device="cpu").import_data()


def _sync():
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def timed_grid(method: str, kind: str, X, y, batched: bool):
    est, grid = baselines._grids(method, kind, DEVICE)
    if not batched:
        est.grid_scores = lambda *a: None  # GridSearchCV then fits each candidate and fold
    _sync()
    t = time.perf_counter()
    gs = GridSearchCV(est, grid, KFold(5, shuffle=True, random_state=42)).fit(X, y)
    _sync()
    return time.perf_counter() - t, gs


def grids(train) -> dict:
    out = {}
    for kind, var in (("categorical", "subtype"), ("numerical", "age")):
        X, y, _ = baselines._prepare_xy(train, var)
        y = y.astype(int) if kind == "categorical" else y
        for method in ("RandomForest", "XGBoost"):
            fast, a = timed_grid(method, kind, X, y, batched=True)
            slow, b = timed_grid(method, kind, X, y, batched=False)
            out[f"{method}_{kind}"] = {
                "batched_s": fast, "separate_s": slow, "speedup": slow / fast,
                "same_best": a.best_params_ == b.best_params_,
                "max_score_diff": float(np.abs(a.cv_results_["mean_test_score"]
                                               - b.cv_results_["mean_test_score"]).max())}
            print(f"{method} {kind}: {out[f'{method}_{kind}']}", flush=True)
    return out


def _gram_f32(tf32: bool):
    def gram(self, A, B):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        dev = torch.device(DEVICE)
        a = torch.as_tensor(A, dtype=torch.float32, device=dev)
        b = torch.as_tensor(B, dtype=torch.float32, device=dev)
        dot = a @ b.t()
        if self.params["kernel"] == "rbf":
            sq = (a * a).sum(1, keepdim=True) + (b * b).sum(1).view(1, -1) - 2 * dot
            k = torch.exp(-self.gamma_ * sq)
        else:
            k = (self.gamma_ * dot + self.params["coef0"]) ** self.params["degree"]
        return k.double().cpu().numpy()
    return gram


def svm_spread(train, test) -> dict:
    def tables(device):
        return baselines.evaluate_baseline_performance(train, test, "subtype", ["SVM"],
                                                       device=device)

    def gap(a, b):
        (sa, pa), (sb, pb) = a, b
        m = max(abs(x["value"] - y["value"]) for x, y in zip(sa, sb)
                if x["value"] is not None or y["value"] is not None)
        p = max(abs(x["probability"] - y["probability"]) for x, y in zip(pa, pb))
        return {"metrics": m, "probabilities": p}

    cpu = tables("cpu")
    out = {"float64": gap(tables(DEVICE), cpu)}
    real = svm._SVM._gram
    try:
        for name, tf32 in (("float32", False), ("float32_tf32", True)):
            svm._SVM._gram = _gram_f32(tf32)
            out[name] = gap(tables(DEVICE), cpu)
    finally:
        svm._SVM._gram = real
        torch.backends.cuda.matmul.allow_tf32 = False
    print(f"SVM tables, card against CPU: {out}", flush=True)
    return out


def boosting(train, test) -> dict:
    X, y, _ = baselines._prepare_xy(train, "subtype")
    Xt = baselines._prepare_xy(test, "subtype")[0]
    fits = {}
    for device in (DEVICE, "cpu"):
        est, _ = baselines._grids("XGBoost", "categorical", device)
        gb = est.clone(**GB).fit(X, y.astype(int))
        fits[device] = (gb.predict_proba(X), gb.predict_proba(Xt))
    out = {"training_rows": float(np.abs(fits[DEVICE][0] - fits["cpu"][0]).max()),
           "held_out_rows": float(np.abs(fits[DEVICE][1] - fits["cpu"][1]).max())}
    print(f"GradientBoosting {GB}, card against CPU: {out}", flush=True)
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=None)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    with tempfile.TemporaryDirectory() as root:
        train, test = reduced_folder(os.path.join(root, "data"))
        result = {"card": card.strip().splitlines()[0], "boosting": boosting(train, test),
                  "svm": svm_spread(train, test), "grids": grids(train)}
    line = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
