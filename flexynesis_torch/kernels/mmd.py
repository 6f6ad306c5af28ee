"""Kernel B3: the Gaussian-kernel mean of the VAE-MMD loss.

Covers the whole of ``flexynesis_tpu/ops/pallas/mmd_kernel.py``:

* ``gaussian_kernel_mean`` launches the hand-written CUDA kernel in
  ``csrc/mmd_kernel.cu`` (replacing the Pallas ``gaussian_kernel_mean``);
  ``gaussian_kernel_mean_ref`` is its plain PyTorch version;
* ``GaussianKernelMean`` is the autograd.Function of the custom VJP
  ``gaussian_kernel_mean_diff``: the kernel forward and the closed-form
  backward in PyTorch ops (the JAX package has no backward kernel either);
* ``compute_mmd_fused`` and ``mmd_loss_fused`` are the counterparts of
  ``compute_mmd_pallas`` and ``mmd_loss_pallas``.

The kernel computes what the Pallas body computes: the Gram expansion
``|x|^2 + |y|^2 - 2 x.y`` clamped at 0 and divided by the unpadded d^2, so it
and its plain version differ only in the order of summation.

The wrapper takes the plain version only for tensors on the CPU. For CUDA
tensors it launches the kernel or raises; there is no size ceiling and no
fallback. ``gaussian_kernel_mean.launches`` counts CUDA launches: one where
the pairs fit one 64 x 64 tile, two otherwise (the tiles' partial sums are
reduced by a second launch in a fixed order, so the result is the same in
every call).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..ops.losses import N_PRIOR_SAMPLES, gaussian_kernel, prior_or_draw
from .build import launcher

# rows of x and of y in one tile of csrc/mmd_kernel.cu (its BM and BN)
TILE = 64


def launches_per_call(n: int, m: int) -> int:
    """CUDA launches of one ``gaussian_kernel_mean`` of (n, d) against (m, d)."""
    return 1 if -(-n // TILE) * -(-m // TILE) == 1 else 2


def gaussian_kernel_mean_ref(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the CPU path and the oracle."""
    return gaussian_kernel(x, y).mean()


def gaussian_kernel_mean(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """mean_ij exp(-max(|x_i|^2 + |y_j|^2 - 2 x_i.y_j, 0) / d^2) as a 0-d tensor.

    x (N, d) and y (M, d), float32. CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    if x.device.type == "cpu":
        return gaussian_kernel_mean_ref(x, y)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[1]:
        raise ValueError(
            f"expected x (N, d) and y (M, d); got {tuple(x.shape)} and {tuple(y.shape)}"
        )
    for name, t in (("x", x), ("y", y)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    (N, d), M = x.shape, y.shape[0]
    if N == 0 or M == 0 or d == 0:
        raise ValueError(f"the kernel mean needs rows and columns; got N={N}, M={M}, d={d}")
    out = torch.empty((), device=x.device, dtype=torch.float32)
    n_launches = launches_per_call(N, M)
    partial = (torch.empty(-(-N // TILE) * -(-M // TILE), device=x.device, dtype=torch.float32)
               if n_launches == 2 else None)
    fn = launcher("mmd_kernel", "gaussian_kernel_mean_f32",
                  [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), y.data_ptr(), None if partial is None else partial.data_ptr(),
                out.data_ptr(), N, M, d, stream)
    if rc != 0:
        raise RuntimeError(
            f"gaussian_kernel_mean kernel launch failed: CUDA error {rc} (N={N}, M={M}, d={d})"
        )
    gaussian_kernel_mean.launches += n_launches
    return out


gaussian_kernel_mean.launches = 0


class GaussianKernelMean(torch.autograd.Function):
    """The kernel forward with the closed-form backward of
    ``mmd_kernel.py::_kmd_bwd`` (:98-113): with K = gaussian_kernel(x, y),
    dm/dx = -2 / (N M d^2) (x * rowsum(K) - K y), and likewise for y. Passed
    the same tensor as x and y, autograd sums both gradients into it."""

    @staticmethod
    def forward(ctx, x, y):
        ctx.save_for_backward(x, y)
        return gaussian_kernel_mean(x, y)

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        (n, d), m = x.shape, y.shape[0]
        K = gaussian_kernel(x, y)
        coef = g * (-2.0 / (n * m * d * float(d)))
        dx = dy = None
        if ctx.needs_input_grad[0]:
            dx = coef * (x * K.sum(dim=1, keepdim=True) - K @ y)
        if ctx.needs_input_grad[1]:
            dy = coef * (y * K.sum(dim=0)[:, None] - K.T @ x)
        return dx, dy


def compute_mmd_fused(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """MMD(x, y) from three kernel means, differentiable; the counterpart of
    ``mmd_kernel.py::compute_mmd_pallas``."""
    return (GaussianKernelMean.apply(x, x) + GaussianKernelMean.apply(y, y)
            - 2.0 * GaussianKernelMean.apply(x, y))


def mmd_loss_fused(z: torch.Tensor, x_hat: torch.Tensor, x: torch.Tensor,
                   prior: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None,
                   n_prior_samples: int = N_PRIOR_SAMPLES) -> torch.Tensor:
    """``ops.losses.mmd_loss`` with the MMD through kernel B3; the counterpart
    of ``mmd_kernel.py::mmd_loss_pallas``."""
    prior = prior_or_draw(z, prior, generator, n_prior_samples)
    return compute_mmd_fused(prior, z) + (x_hat - x).square().mean()
