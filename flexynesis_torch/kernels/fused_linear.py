"""Kernels B1 and B2: fused Linear -> BatchNorm -> ReLU.

* ``fused_linear_bn_relu`` (B1, training mode, batch statistics) replaces
  ``flexynesis_tpu/ops/pallas/fused_linear.py::fused_linear_bn_relu`` with the
  hand-written CUDA kernel in ``csrc/fused_linear_train.cu``. It returns
  ``(y, batch_mean, batch_var)`` like the JAX function; its backward is the
  JAX ``_bwd`` formula in PyTorch ops (the JAX package has no backward kernel
  either).
* ``fused_linear_bn_relu_eval`` (B2, running statistics) replaces
  ``fused_linear_bn_relu_eval`` there with ``csrc/fused_linear_eval.cu``.

Both keep the JAX signatures and the ``(F, H)`` weight layout; each source's
header says what bounds the kernel and how its design answers that.

A wrapper takes the plain version only for tensors on the CPU. For CUDA
tensors it launches the kernel or raises; there is no size ceiling and no
fallback. ``<wrapper>.launches`` counts the CUDA launches of its kernels.
"""

from __future__ import annotations

import ctypes

import torch


def fused_linear_bn_relu_eval_ref(x, w, b, gamma, beta, running_mean,
                                  running_var, eps: float = 1e-5):
    """Plain PyTorch version of the kernel: the CPU path and the oracle."""
    h = x @ w + b
    return torch.relu((h - running_mean) * torch.rsqrt(running_var + eps) * gamma + beta)


_launchers: dict = {}


def _kernel(name: str, symbol: str, argtypes):
    """The C launcher ``symbol`` of ``csrc/<name>.cu``, built at first use."""
    if name not in _launchers:
        from . import build

        fn = getattr(build.load(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _launchers[name] = fn
    return _launchers[name]


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
    fn = _kernel("fused_linear_eval", "fused_linear_bn_relu_eval_f32",
                 [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p])
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


# ------------------------------------------------------ B1: batch statistics


def fused_linear_bn_relu_ref(x, w, b, gamma, beta, eps: float = 1e-5):
    """Plain PyTorch version of kernel B1 (the unfused math of
    ``fused_linear.py:93-101``): returns ``(y, h, batch_mean, batch_var)``
    with the biased batch variance. Differentiable by autograd; the CPU path
    and the oracle."""
    h = x @ w + b
    mu = h.mean(dim=0)
    centered = h - mu
    var = centered.square().mean(dim=0)
    y = torch.relu(centered * torch.rsqrt(var + eps) * gamma + beta)
    return y, h, mu, var


# rows of one tile of csrc/fused_linear_train.cu (its BM); above it the kernel
# writes per-tile partial statistics that a second launch merges
ROW_TILE = 64


def fused_linear_bn_relu_forward(x, w, b, gamma, beta, eps: float = 1e-5):
    """Forward of B1 without autograd: ``(y, h, batch_mean, batch_var)``.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if x.device.type == "cpu":
        with torch.no_grad():
            return fused_linear_bn_relu_ref(x, w, b, gamma, beta, eps)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    _check(x, w, (("b", b), ("gamma", gamma), ("beta", beta)))
    B, F = x.shape
    H = w.shape[1]
    if B == 0:
        raise ValueError("batch statistics need at least one row")
    dev = dict(device=x.device, dtype=torch.float32)
    y = torch.empty((B, H), **dev)
    h = torch.empty((B, H), **dev)
    mu = torch.empty((H,), **dev)
    var = torch.empty((H,), **dev)
    if H == 0:
        return y, h, mu, var
    tiles = -(-B // ROW_TILE)
    part = torch.empty((2, tiles, H), **dev) if tiles > 1 else None
    fn = _kernel("fused_linear_train", "fused_linear_bn_relu_train_f32",
                 [ctypes.c_void_p] * 11 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), gamma.data_ptr(),
                beta.data_ptr(), h.data_ptr(), y.data_ptr(), mu.data_ptr(),
                var.data_ptr(),
                None if part is None else part[0].data_ptr(),
                None if part is None else part[1].data_ptr(),
                B, F, H, float(eps), stream)
    if rc != 0:
        raise RuntimeError(
            f"fused_linear_bn_relu kernel launch failed: CUDA error {rc} "
            f"(B={B}, F={F}, H={H})"
        )
    # the tile kernel, and the merge kernel where the batch spans row tiles
    fused_linear_bn_relu.launches += 1 if part is None else 2
    return y, h, mu, var


class FusedLinearBNReLU(torch.autograd.Function):
    """Kernel B1 forward with the JAX ``_bwd`` backward (fused_linear.py:160-179).

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
        inv = torch.rsqrt(var + ctx.eps)
        hn = (h - mu) * inv
        g = gy * (hn * gamma + beta > 0).to(gy.dtype)
        dgamma = (g * hn).sum(dim=0)
        dbeta = g.sum(dim=0)
        ghn = g * gamma
        dh = (ghn - ghn.mean(dim=0, keepdim=True)
              - hn * (ghn * hn).mean(dim=0, keepdim=True)) * inv
        dx = dh @ w.T if ctx.needs_input_grad[0] else None
        dw = x.T @ dh if ctx.needs_input_grad[1] else None
        db = dh.sum(dim=0)
        return dx, dw, db, dgamma, dbeta, None


def fused_linear_bn_relu(x, w, b, gamma, beta, eps: float = 1e-5):
    """relu(batchnorm(x @ w + b)) with batch statistics, differentiable.

    x (B, F), w (F, H), vectors (H,), float32 on the card; returns
    ``(y, batch_mean, batch_var)`` with the biased variance.
    ``fused_linear_bn_relu.launches`` counts CUDA launches: one per forward,
    two where B > 64 (the tile kernel and the merge of the split reduction)."""
    return FusedLinearBNReLU.apply(x, w, b, gamma, beta, eps)


fused_linear_bn_relu.launches = 0
