"""Operations and bytes of the model step and of the hand-written kernel
that a cell runs (B3, the Gaussian-kernel MMD), computed from shapes, and the peaks they are held against.

The peaks are one NVIDIA H100 SXM's published dense rates (NVIDIA's data
sheet, 700 W): 495 TFLOP/s in TF32 and 3.35 TB/s of HBM. TF32 is the fastest
rate at which any product of float32 inputs runs on the card, so no
float32-accurate implementation of the same work (FMA, 3xTF32, split bf16)
can take less than these least times, and no share computed here can pass
100% unless the operations or bytes are counted too high or the time leaves
out part of the work.

Counting rules (the kernel count is that of ``chip_smoke.py``'s
``work_term``, recounted against one peak):

* a matrix product of (B, F) by (F, H) is 2 B F H operations;
* a model step is forward plus backward, 3 x 2 x matmul parameters x rows,
  each trial counted at its own unpadded architecture (padding is waste);
  a validation or attribution forward is 2 x parameters x rows, and an
  input gradient is another 2 x parameters x rows;
* B3 adds 6 operations per pair beside the 2 d of its dot product and 2 d
  per row for the norms;
* bytes count each input read once and each output written once, in f32.
"""

from __future__ import annotations

from typing import Dict, Iterable, Sequence, Tuple

PEAK_FLOPS = 495e12       # dense TF32, NVIDIA H100 SXM data sheet
PEAK_BYTES = 3.35e12      # HBM3, NVIDIA H100 SXM data sheet
F32 = 4


def hidden_width(n_in: int, factor: float) -> int:
    return max(int(n_in * float(factor)), 2)


def matmul_shapes(model_class: str, arch: dict, input_dims: Sequence[int],
                  n_classes: int) -> list:
    """The (in, out) shapes of every matrix product of one model of
    ``arch`` (latent_dim, hidden_dim_factor, supervisor_hidden_dim) over
    layers of ``input_dims`` with one categorical target of ``n_classes``."""
    lat = int(arch["latent_dim"])
    sup = max(int(arch["supervisor_hidden_dim"]), 2)
    fac = float(arch["hidden_dim_factor"])
    n_layers = len(input_dims)
    shapes = []
    if model_class == "DirectPred":
        for f in input_dims:
            h = hidden_width(f, fac)
            shapes += [(f, h), (h, lat)]
        if n_layers > 1:
            shapes.append((n_layers * lat, lat))
    elif model_class == "supervised_vae":
        for f in input_dims:
            h = hidden_width(f, fac)
            shapes += [(f, h), (h, lat), (h, lat)]           # hidden, FC_mean, FC_var
        shapes += [(n_layers * lat, lat)] * 2                # FC_mean, FC_log_var
        for f in input_dims:
            h = hidden_width(f, fac)
            shapes += [(lat, h), (h, f)]                     # decoder
    else:
        raise ValueError(f"no work count for {model_class}")
    shapes += [(lat, sup), (sup, n_classes)]
    return shapes


def matmul_params(model_class: str, arch: dict, input_dims: Sequence[int],
                  n_classes: int) -> int:
    return sum(i * o for i, o in matmul_shapes(model_class, arch, input_dims, n_classes))


def train_flops(params: int, rows: int) -> float:
    return 6.0 * params * rows


def forward_flops(params: int, rows: int) -> float:
    return 2.0 * params * rows


def ig_flops(params: int, rows: int, n_classes: int) -> float:
    """One IG pass over ``rows`` points: one forward and one input gradient
    per class."""
    return 2.0 * params * rows * (1 + n_classes)


def b3_term_work(K: int, N: int, M: int, d: int, prior_per_trial: bool) -> Tuple[float, float]:
    """(operations, bytes) of one B3 MMD-term launch: K trials of the three
    Gaussian kernel means of an (N, d) prior and (M, d) latent rows, a self
    set over its distinct pairs; a prior shared by the trials read, and its
    self-mean needed, once. Four floats written per trial."""
    n_x = K if prior_per_trial else 1
    pairs = n_x * N * (N + 1) // 2 + K * (M * (M + 1) // 2 + N * M)
    rows = n_x * N + K * M
    return 2.0 * pairs * d + 2.0 * rows * d + 6.0 * pairs, F32 * (rows * d + 4 * K)


def b3_mean_work(N: int, M: int, d: int) -> Tuple[float, float]:
    """(operations, bytes) of one B3 kernel-mean launch of (N, d) against (M, d)."""
    return 2.0 * N * M * d + 2.0 * (N + M) * d + 6.0 * N * M, F32 * ((N + M) * d + 1)


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time of a call: its operations at the peak rate or its
    bytes at the memory rate, whichever is longer."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def share_pct(least_s: float, device_s: float):
    """100 x least time / device time, or None where nothing ran."""
    if device_s <= 0 or least_s <= 0:
        return None
    return 100.0 * least_s / device_s


def mfu_pct(flops: float, seconds: float):
    if seconds <= 0 or flops <= 0:
        return None
    return 100.0 * flops / (seconds * PEAK_FLOPS)


def total_least(calls: Iterable[Tuple[float, float]]) -> float:
    return sum(least_seconds(f, b) for f, b in calls)


def dims_of(config: dict) -> Dict[str, int]:
    return {k: int(v) for k, v in config["features"].items()}
