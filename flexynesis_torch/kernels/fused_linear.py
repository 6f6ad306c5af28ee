"""Kernels B1 and B2: fused Linear -> BatchNorm -> ReLU.

* ``fused_linear_bn_relu`` (B1, training mode, batch statistics) replaces
  ``flexynesis_tpu/ops/pallas/fused_linear.py::fused_linear_bn_relu`` with the
  hand-written CUDA kernel in ``csrc/fused_linear_train.cu``. It returns
  ``(y, batch_mean, batch_var)`` like the JAX function; its backward is the
  JAX ``_bwd`` formula in PyTorch ops (the JAX package has no backward kernel
  either).
* ``fused_linear_bn_relu_eval`` (B2, running statistics) replaces
  ``fused_linear_bn_relu_eval`` there with ``csrc/fused_linear_eval.cu``: a
  64 x 64 tile of y per cluster of CTAs that split F, the product on the
  tensor cores in 3xTF32 (about f32 accuracy), loads through a ``cp.async``
  ring, the split's partials summed in rank order through distributed shared
  memory, and bias, BatchNorm and ReLU in the epilogue.

Both keep the JAX signatures and the ``(F, H)`` weight layout; each source's
header says what bounds the kernel and how its design answers that. Both
split F over a thread-block cluster as the pure-Python planners ``plan_b1``
and ``plan_b2`` say, per launch.

Both take a leading trial axis, the counterpart of ``vmap`` over the
``pallas_call`` in the JAX trial engine: ``w`` (K, F, H), the vectors (K, H)
and the outputs (K, B, H) and (K, H); ``x`` is (K, B, F), or one (B, F) that
every trial reads. The K trials run in one launch (trial k in the grid's y),
and a call without the axis is the launch of K = 1.

A wrapper takes the plain version only for tensors on the CPU. For CUDA
tensors it launches the kernel on the current stream of the tensors' device
(which must be the current device) or raises; there is no size ceiling and no
fallback. ``<wrapper>.launches`` counts the CUDA launches of its kernels.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import threading
from typing import NamedTuple

import torch

from .build import current_stream, launcher

# the tilings of csrc/fused_linear_train.cu (B1: 64-row x 32-column tiles of
# h; above ROW_TILE rows each row tile writes partial statistics that a
# second launch merges) and csrc/fused_linear_eval.cu (B2: 64 x 64 tiles of
# y); they walk F in 16- and 32-deep stages and split it over a cluster of
# CTAs
ROW_TILE = 64
COL_TILE = 32
B2_COL_TILE = 64
K_STAGE = 16
B2_K_STAGE = 32
MAX_SPLIT = 8  # the portable cluster size
MIN_SLICE = 64  # the least depth of F worth a CTA of its own
H100_SMS = 132
# the CTAs of B2 one SM holds at once (the minimum of its __launch_bounds__;
# its registers and shared memory allow 3): B2 is split until the grid fills
# these slots, since one CTA (a warp per scheduler) cannot hide the latency
# of its mma.sync and shared-memory loads
B2_CTAS_PER_SM = 3


class SplitPlan(NamedTuple):
    """How one B1 or B2 launch splits its work: ``split`` CTAs (a cluster)
    share each of the ``tiles`` output tiles, CTA r over depth
    [r * slice, min(F, (r + 1) * slice)) of F."""

    split: int
    slice: int
    tiles: int

    @property
    def ctas(self) -> int:
        return self.split * self.tiles


def _slice(F: int, split: int, k_stage: int) -> int:
    """The depth of each of ``split`` slices of F, rounded up to whole stages."""
    return -(-(-(-F // split)) // k_stage) * k_stage


@functools.lru_cache(maxsize=1024)
def _plan(B: int, F: int, H: int, col_tile: int, k_stage: int, slots: int,
          trials: int = 1) -> SplitPlan:
    """Double the split of F while the grid has fewer CTAs than ``slots``,
    each slice keeps at least MIN_SLICE of depth and the last CTA still has
    depth of its own, up to MAX_SPLIT. Slices are whole stages, so no
    16-byte copy straddles two CTAs. The tiles of all ``trials`` count
    together. Cached per shape: a wrapper plans every call."""
    tiles = trials * -(-B // ROW_TILE) * -(-H // col_tile)
    split = 1
    while (split < MAX_SPLIT and tiles * split < slots and F >= 2 * split * MIN_SLICE
           and (2 * split - 1) * _slice(F, 2 * split, k_stage) < F):
        split *= 2
    return SplitPlan(split, _slice(F, split, k_stage), tiles)


def plan_b1(B: int, F: int, H: int, sms: int = H100_SMS, trials: int = 1) -> SplitPlan:
    """Cluster size and slice depth of a B1 launch (64 x 32 tiles of h, for
    each of ``trials`` trials), split until the grid has a CTA per SM. A
    shape with many tiles (a large batch, or 16 trials of an encoder) or a
    shallow F (the 64-wide head) keeps split 1."""
    return _plan(B, F, H, COL_TILE, K_STAGE, sms, trials)


def plan_b2(B: int, F: int, H: int, sms: int = H100_SMS, trials: int = 1) -> SplitPlan:
    """Cluster size and slice depth of a B2 launch (64 x 64 tiles of y, for
    each of ``trials`` trials), split until the grid fills the
    B2_CTAS_PER_SM slots of every SM: split 8 at the encoders of 64-, 400-
    and 500-row batches, 2 and 4 at the 2000-row cohort's encoders (which
    also spreads their tiles evenly over the SMs), 1 at the 64-deep head and
    at 16 trials of a 400-row validation."""
    return _plan(B, F, H, B2_COL_TILE, B2_K_STAGE, B2_CTAS_PER_SM * sms, trials)


_PLANNED = threading.local()


@contextlib.contextmanager
def planned_for(trials: int):
    """Plan the B1 and B2 launches made inside the block as for a launch of
    ``trials`` trials (a shard of a round plans as the whole round): the
    split of F, and with it each trial's order of summation, then does not
    depend on how many of the round's trials share a launch, so a trial
    sharded over a mesh computes the bits it computes unsharded. A shard's
    grid has fewer CTAs than the plan assumed."""
    prev = getattr(_PLANNED, "trials", None)
    _PLANNED.trials = int(trials)
    try:
        yield
    finally:
        _PLANNED.trials = prev


def _plan_trials(K: int) -> int:
    planned = getattr(_PLANNED, "trials", None)
    return K if planned is None else max(K, planned)


_SMS: dict = {}


def _sm_count(device) -> int:
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return _SMS[device]


def fused_linear_bn_relu_eval_ref(x, w, b, gamma, beta, running_mean,
                                  running_var, eps: float = 1e-5):
    """Plain PyTorch version of the kernel: the CPU path and the oracle. With a
    trial axis, ``x @ w`` broadcasts a (B, F) x over the K trials."""
    h = x @ w + b.unsqueeze(-2)
    return torch.relu((h - running_mean.unsqueeze(-2))
                      * torch.rsqrt(running_var + eps).unsqueeze(-2)
                      * gamma.unsqueeze(-2) + beta.unsqueeze(-2))


def _check(x, w, vectors):
    """Shapes, devices, types and layout of a call; returns (lead, K,
    x_per_trial, B, F, H): ``lead`` is (K,) with a trial axis and () without,
    where K is 1."""
    stacked = w.dim() == 3
    K = w.shape[0] if stacked else 1
    F = w.shape[-2] if w.dim() >= 2 else -1
    ok = (w.dim() in (2, 3) and x.dim() in (2, 3) and x.shape[-1] == F
          and (x.dim() == 2 or (stacked and x.shape[0] == K)))
    if not ok:
        raise ValueError(
            "expected x (B, F) and w (F, H), or w (K, F, H) with x (B, F) or "
            f"(K, B, F); got {tuple(x.shape)} and {tuple(w.shape)}"
        )
    H = w.shape[-1]
    for name, t in (("x", x), ("w", w), *vectors):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    want = (K, H) if stacked else (H,)
    for name, t in vectors:
        if tuple(t.shape) != want:
            raise ValueError(f"{name} must have shape {want}, got {tuple(t.shape)}")
    return (K,) if stacked else (), K, x.dim() == 3, x.shape[-2], F, H


def fused_linear_bn_relu_eval(x, w, b, gamma, beta, running_mean, running_var,
                              eps: float = 1e-5):
    """relu((x @ w + b - running_mean) * rsqrt(running_var + eps) * gamma + beta).

    x (B, F), w (F, H), vectors (H,), all float32; returns y (B, H). With a
    trial axis: w (K, F, H), vectors (K, H), x (B, F) for every trial or
    (K, B, F); returns (K, B, H). On the card: one launch per call, split as
    ``plan_b2`` says. ``fused_linear_bn_relu_eval.launches`` counts kernel
    launches."""
    if x.device.type == "cpu":
        return fused_linear_bn_relu_eval_ref(
            x, w, b, gamma, beta, running_mean, running_var, eps
        )
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    vectors = (("b", b), ("gamma", gamma), ("beta", beta),
               ("running_mean", running_mean), ("running_var", running_var))
    lead, K, per_trial, B, F, H = _check(x, w, vectors)
    stream = current_stream(x.device)
    y = torch.empty((*lead, B, H), device=x.device, dtype=torch.float32)
    if y.numel() == 0:
        return y
    plan = plan_b2(B, F, H, _sm_count(x.device), _plan_trials(K))
    fn = launcher("fused_linear_eval", "fused_linear_bn_relu_eval_f32",
                  [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p])
    rc = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), gamma.data_ptr(),
            beta.data_ptr(), running_mean.data_ptr(), running_var.data_ptr(),
            y.data_ptr(), K, int(per_trial), B, F, H, plan.split, plan.slice,
            float(eps), stream)
    if rc != 0:
        raise RuntimeError(
            f"fused_linear_bn_relu_eval kernel launch failed: CUDA error {rc} "
            f"(K={K}, B={B}, F={F}, H={H}, {plan})"
        )
    fused_linear_bn_relu_eval.launches += 1
    return y


fused_linear_bn_relu_eval.launches = 0


# ------------------------------------------------------ B1: batch statistics


def fused_linear_bn_relu_ref(x, w, b, gamma, beta, eps: float = 1e-5):
    """Plain PyTorch version of kernel B1 (the unfused math of
    ``fused_linear.py:93-101``): returns ``(y, h, batch_mean, batch_var)``
    with the biased batch variance, per trial where there is a trial axis.
    Differentiable by autograd; the CPU path and the oracle."""
    h = x @ w + b.unsqueeze(-2)
    mu = h.mean(dim=-2)
    centered = h - mu.unsqueeze(-2)
    var = centered.square().mean(dim=-2)
    y = torch.relu(centered * torch.rsqrt(var + eps).unsqueeze(-2) * gamma.unsqueeze(-2)
                   + beta.unsqueeze(-2))
    return y, h, mu, var


def fused_linear_bn_relu_forward(x, w, b, gamma, beta, eps: float = 1e-5):
    """Forward of B1 without autograd: ``(y, h, batch_mean, batch_var)``,
    with or without a trial axis.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if x.device.type == "cpu":
        with torch.no_grad():
            return fused_linear_bn_relu_ref(x, w, b, gamma, beta, eps)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    lead, K, per_trial, B, F, H = _check(x, w, (("b", b), ("gamma", gamma), ("beta", beta)))
    if B == 0:
        raise ValueError("batch statistics need at least one row")
    stream = current_stream(x.device)
    row_tiles = -(-B // ROW_TILE)
    # one allocation: y and h (K, B, H), mean and var (K, H), and above one
    # row tile the per-tile (mean, M2) partials (2, K, row_tiles, H)
    n_part = 2 * K * row_tiles * H if row_tiles > 1 else 0
    buf = torch.empty(2 * K * B * H + 2 * K * H + n_part, device=x.device,
                      dtype=torch.float32)
    y, h = buf[: 2 * K * B * H].view(2, *lead, B, H)
    mu, var = buf[2 * K * B * H: 2 * K * B * H + 2 * K * H].view(2, *lead, H)
    if H == 0 or K == 0:
        return y, h, mu, var
    plan = plan_b1(B, F, H, _sm_count(x.device), _plan_trials(K))
    part = buf[2 * K * B * H + 2 * K * H:].view(2, K, row_tiles, H) if n_part else None
    fn = launcher("fused_linear_train", "fused_linear_bn_relu_train_f32",
                  [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7
                  + [ctypes.c_float, ctypes.c_void_p])
    rc = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), gamma.data_ptr(),
            beta.data_ptr(), h.data_ptr(), y.data_ptr(), mu.data_ptr(),
            var.data_ptr(),
            None if part is None else part[0].data_ptr(),
            None if part is None else part[1].data_ptr(),
            K, int(per_trial), B, F, H, plan.split, plan.slice, float(eps), stream)
    if rc != 0:
        raise RuntimeError(
            f"fused_linear_bn_relu kernel launch failed: CUDA error {rc} "
            f"(K={K}, B={B}, F={F}, H={H}, {plan})"
        )
    # the cluster kernel, and the merge kernel where the batch spans row tiles
    fused_linear_bn_relu.launches += 1 if part is None else 2
    return y, h, mu, var


class FusedLinearBNReLU(torch.autograd.Function):
    """Kernel B1 forward with the JAX ``_bwd`` backward (fused_linear.py:160-179),
    per trial where there is a trial axis: batched matrix products over K.

    The batch mean and variance are outputs without gradient: the JAX
    backward ignores their cotangents."""

    @staticmethod
    def forward(ctx, x, w, b, gamma, beta, eps):
        y, h, mu, var = fused_linear_bn_relu_forward(x, w, b, gamma, beta, eps)
        ctx.save_for_backward(x, w, gamma, beta, h, mu, var)
        ctx.eps = eps
        ctx.mark_non_differentiable(mu, var)
        return y, mu, var

    @staticmethod
    def backward(ctx, gy, _gmu, _gvar):
        x, w, gamma, beta, h, mu, var = ctx.saved_tensors
        inv = torch.rsqrt(var + ctx.eps).unsqueeze(-2)
        hn = (h - mu.unsqueeze(-2)) * inv
        g = gy * (hn * gamma.unsqueeze(-2) + beta.unsqueeze(-2) > 0).to(gy.dtype)
        dgamma = (g * hn).sum(dim=-2)
        dbeta = g.sum(dim=-2)
        ghn = g * gamma.unsqueeze(-2)
        dh = (ghn - ghn.mean(dim=-2, keepdim=True)
              - hn * (ghn * hn).mean(dim=-2, keepdim=True)) * inv
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = dh @ w.mT
            if dx.dim() > x.dim():  # one x read by every trial
                dx = dx.sum(dim=0)
        if ctx.needs_input_grad[1]:
            dw = x.mT @ dh
        db = dh.sum(dim=-2)
        return dx, dw, db, dgamma, dbeta, None


def fused_linear_bn_relu(x, w, b, gamma, beta, eps: float = 1e-5):
    """relu(batchnorm(x @ w + b)) with batch statistics, differentiable.

    x (B, F), w (F, H), vectors (H,), float32 on the card; returns
    ``(y, batch_mean, batch_var)`` with the biased variance. With a trial
    axis: w (K, F, H), vectors (K, H), x (B, F) for every trial or (K, B, F);
    returns (K, B, H), (K, H) and (K, H), each trial's own statistics.
    ``fused_linear_bn_relu.launches`` counts CUDA launches: one per forward
    (of all K trials), two where B > 64 (the cluster kernel and the merge of
    the split reduction)."""
    return FusedLinearBNReLU.apply(x, w, b, gamma, beta, eps)


fused_linear_bn_relu.launches = 0
