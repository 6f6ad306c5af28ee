"""Kernel B2: eval-mode fused Linear -> BatchNorm -> ReLU.

``fused_linear_bn_relu_eval`` replaces
``flexynesis_tpu/ops/pallas/fused_linear.py::fused_linear_bn_relu_eval`` with
the hand-written CUDA kernel in ``csrc/fused_linear_eval.cu`` (see its header
for the design and what bounds it). It keeps the JAX signature and the
``(F, H)`` weight layout.

The wrapper takes the plain version only for tensors on the CPU. For CUDA
tensors it launches the kernel or raises; it has no size ceiling and no
fallback.
"""

from __future__ import annotations

import ctypes

import torch


def fused_linear_bn_relu_eval_ref(x, w, b, gamma, beta, running_mean,
                                  running_var, eps: float = 1e-5):
    """Plain PyTorch version of the kernel: the CPU path and the oracle."""
    h = x @ w + b
    return torch.relu((h - running_mean) * torch.rsqrt(running_var + eps) * gamma + beta)


_launcher = None


def _kernel():
    """The C launcher of csrc/fused_linear_eval.cu, built at first use."""
    global _launcher
    if _launcher is None:
        from . import build

        fn = build.load("fused_linear_eval").fused_linear_bn_relu_eval_f32
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [
            ctypes.c_float, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _launcher = fn
    return _launcher


def _check(x, w, vectors):
    if x.dim() != 2 or w.dim() != 2 or w.shape[0] != x.shape[1]:
        raise ValueError(
            f"expected x (B, F) and w (F, H); got {tuple(x.shape)} and {tuple(w.shape)}"
        )
    H = w.shape[1]
    for name, t in (("x", x), ("w", w), *vectors):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in vectors:
        if tuple(t.shape) != (H,):
            raise ValueError(f"{name} must have shape ({H},), got {tuple(t.shape)}")


def fused_linear_bn_relu_eval(x, w, b, gamma, beta, running_mean, running_var,
                              eps: float = 1e-5):
    """relu((x @ w + b - running_mean) * rsqrt(running_var + eps) * gamma + beta).

    x (B, F), w (F, H), vectors (H,), all float32; returns y (B, H).
    ``fused_linear_bn_relu_eval.launches`` counts kernel launches."""
    if x.device.type == "cpu":
        return fused_linear_bn_relu_eval_ref(
            x, w, b, gamma, beta, running_mean, running_var, eps
        )
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    vectors = (("b", b), ("gamma", gamma), ("beta", beta),
               ("running_mean", running_mean), ("running_var", running_var))
    _check(x, w, vectors)
    B, F = x.shape
    H = w.shape[1]
    y = torch.empty((B, H), device=x.device, dtype=torch.float32)
    if B == 0 or H == 0:
        return y
    fn = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), gamma.data_ptr(),
                beta.data_ptr(), running_mean.data_ptr(), running_var.data_ptr(),
                y.data_ptr(), B, F, H, float(eps), stream)
    if rc != 0:
        raise RuntimeError(
            f"fused_linear_bn_relu_eval kernel launch failed: CUDA error {rc} "
            f"(B={B}, F={F}, H={H})"
        )
    fused_linear_bn_relu_eval.launches += 1
    return y


fused_linear_bn_relu_eval.launches = 0
