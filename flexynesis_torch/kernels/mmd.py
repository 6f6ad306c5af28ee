"""Kernel B3: the Gaussian-kernel means of the VAE-MMD loss.

Covers the whole of ``flexynesis_tpu/ops/pallas/mmd_kernel.py``:

* ``gaussian_kernel_mean`` launches the hand-written CUDA kernel in
  ``csrc/mmd_kernel.cu`` for one mean (replacing the Pallas
  ``gaussian_kernel_mean``); ``gaussian_kernel_mean_ref`` is its plain
  PyTorch version;
* ``GaussianKernelMean`` is the autograd.Function of the custom VJP
  ``gaussian_kernel_mean_diff``: the kernel forward and the closed-form
  backward in PyTorch ops (the JAX package has no backward kernel either);
* ``mmd_term_forward`` runs a whole MMD term (the three means of
  ``compute_mmd_pallas``) in one launch of the same kernel, and ``MMDTerm`` is
  its autograd.Function; ``compute_mmd_fused`` and ``mmd_loss_fused`` are the
  counterparts of ``compute_mmd_pallas`` and ``mmd_loss_pallas``.

The MMD term takes a leading trial axis K, the axis ``vmap`` over
``mmd_loss_pallas`` gives the JAX trial engine (mmd_kernel.py:128-137): z
(K, M, d) against a prior of (K, N, d), or one (N, d) that the kernel reads
at a trial stride of 0 (trials that share a seed share their draws). One
launch covers the K trials; each trial has its own ticket and range of
partials, and its last block reduces it alone, so trial k of a K-trial call
equals a one-trial call on slice k bit for bit. The backward is the closed
form in batched products, as JAX leaves it to XLA.

The kernel computes what the Pallas body computes: the Gram expansion
``|x|^2 + |y|^2 - 2 x.y`` clamped at 0 and divided by the unpadded d^2, so it
and its plain version differ only in the order of summation.

The wrappers take the plain version only for tensors on the CPU. For CUDA
tensors they launch the kernel or raise; there is no size ceiling and no
fallback. Every call is one CUDA launch, counted in
``gaussian_kernel_mean.launches``: the tiles' partial sums are reduced in the
same launch, in a fixed order, so the result is the same in every call.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ..ops.losses import N_PRIOR_SAMPLES, gaussian_kernel, kernel_mean, prior_or_draw, recon_mse
from .build import current_stream, launcher

# rows of each side in one tile of csrc/mmd_kernel.cu (its BT)
TILE = 64


def pair_tiles(n: int, m: int, self_pairs: bool = False) -> int:
    """Tiles (blocks) of one pair set of n rows against m rows; a self set
    (the rows against themselves, n == m) runs only its upper triangle."""
    tn, tm = -(-n // TILE), -(-m // TILE)
    return tn * (tn + 1) // 2 if self_pairs else tn * tm


def decode_tile(t: int, n: int, m: int, self_pairs: bool = False):
    """The t-th tile of a pair set as (ti, tj, weight), as the kernel's
    ``decode_tile`` finds it: row-major over the tiles, over the upper
    triangle (ti <= tj) for a self set, whose off-diagonal tiles weigh 2."""
    tiles_a, tiles_b = -(-n // TILE), -(-m // TILE)
    if not self_pairs:
        return t // tiles_b, t % tiles_b, 1

    def start(i):  # the first t of row i
        return i * tiles_a - i * (i - 1) // 2

    q = 2 * tiles_a + 1
    i = min(max(int((q - math.sqrt(q * q - 8.0 * t)) / 2.0), 0), tiles_a - 1)
    while i > 0 and start(i) > t:
        i -= 1
    while i + 1 < tiles_a and start(i + 1) <= t:
        i += 1
    tj = i + (t - start(i))
    return i, tj, 1 if i == tj else 2


def term_sets(n: int, m: int):
    """The pair sets of one MMD term of x (n rows) and y (m rows), in the
    kernel's grid order: (rows of a, rows of b, self set)."""
    return [(n, n, True), (m, m, True), (n, m, False)]


def call_tiles(n: int, m: int, term: bool) -> int:
    """Blocks of one launch: a mean of n rows against m, or an MMD term."""
    sets = term_sets(n, m) if term else [(n, m, False)]
    return sum(pair_tiles(a, b, s) for a, b, s in sets)


def launches_per_call(n: int, m: int) -> int:
    """CUDA launches of one ``gaussian_kernel_mean`` of (n, d) against (m, d),
    or of one MMD term: one, whatever the shape."""
    return 1


def gaussian_kernel_mean_ref(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the CPU path and the oracle."""
    return kernel_mean(x, y)


def mmd_term_ref(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Plain version of one MMD term: [mean(x, x), mean(y, y), mean(x, y),
    MMD], the MMD as ``ops.losses.compute_mmd`` forms it; (K, 4) with a
    trial axis (y (K, M, d), x (K, N, d) or shared (N, d))."""
    kxx, kyy, kxy = torch.broadcast_tensors(
        *(kernel_mean(a, b) for a, b in ((x, x), (y, y), (x, y))))
    return torch.stack([kxx, kyy, kxy, kxx + kyy - 2.0 * kxy], dim=-1)


# one workspace per (device, stream): an int32 ticket per trial (0 between
# launches) and the tiles' partial sums of every trial, grown on demand and
# never shrunk
_workspaces: dict = {}


def _workspace(device, stream: int, trials: int, tiles: int):
    """(tickets, partials) for a launch of ``trials`` x ``tiles`` blocks."""
    ws = _workspaces.get((device, stream))
    if ws is None or ws[0].numel() < trials or ws[1].numel() < trials * tiles:
        n_tickets = max(trials, 16, 0 if ws is None else ws[0].numel())
        n_partials = max(trials * tiles, 256, 0 if ws is None else 2 * ws[1].numel())
        ws = (torch.zeros(n_tickets, device=device, dtype=torch.int32),
              torch.empty(n_partials, device=device, dtype=torch.float32))
        _workspaces[device, stream] = ws
    return ws


def _launch(symbol: str, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """One launch of csrc/mmd_kernel.cu's ``symbol`` on CUDA tensors: the
    mean of x (N, d) against y (M, d) as a (1,) tensor, or the MMD term, (4,)
    for y (M, d) and (K, 4) for y (K, M, d) against x (K, N, d) or a shared
    x (N, d)."""
    term = symbol == "mmd_term_f32"
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    trial_axis = term and y.dim() == 3
    if (y.dim() != (3 if trial_axis else 2) or x.dim() not in ((2, 3) if trial_axis else (2,))
            or x.shape[-1] != y.shape[-1]
            or (x.dim() == 3 and x.shape[0] != y.shape[0])):
        raise ValueError(
            f"expected x (N, d) and y (M, d), or for an MMD term y (K, M, d) and x (K, N, d) "
            f"or (N, d); got {tuple(x.shape)} and {tuple(y.shape)}"
        )
    for name, t in (("x", x), ("y", y)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    (N, d), M = x.shape[-2:], y.shape[-2]
    K = y.shape[0] if trial_axis else 1
    if N == 0 or M == 0 or d == 0 or K == 0:
        raise ValueError(f"the kernel mean needs rows and columns; got K={K}, N={N}, M={M}, "
                         f"d={d}")
    stream = current_stream(x.device)
    tickets, partials = _workspace(x.device, stream, K, call_tiles(N, M, term))
    out = torch.empty(*y.shape[:-2], 4 if term else 1, device=x.device, dtype=torch.float32)
    head = [ctypes.c_void_p] * 2
    if term:  # K and x's trial stride (0: x shared by the trials)
        head += [ctypes.c_int, ctypes.c_longlong]
    fn = launcher("mmd_kernel", symbol, head + [ctypes.c_int] * 3
                  + [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 3)
    trial_args = (K, N * d if x.dim() == 3 else 0) if term else ()
    rc = fn(x.data_ptr(), y.data_ptr(), *trial_args, N, M, d, partials.data_ptr(),
            partials.numel(), tickets.data_ptr(), out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"{symbol} kernel launch failed: CUDA error {rc} (K={K}, N={N}, "
                           f"M={M}, d={d})")
    gaussian_kernel_mean.launches += 1
    return out


def gaussian_kernel_mean(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """mean_ij exp(-max(|x_i|^2 + |y_j|^2 - 2 x_i.y_j, 0) / d^2) as a 0-d tensor.

    x (N, d) and y (M, d), float32. CPU tensors take the plain version; CUDA
    tensors launch the kernel once."""
    if x.device.type == "cpu":
        return gaussian_kernel_mean_ref(x, y)
    return _launch("gaussian_kernel_mean_f32", x, y)[0]


gaussian_kernel_mean.launches = 0


def mmd_term_forward(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """[mean(x, x), mean(y, y), mean(x, y), MMD] of x (N, d) and y (M, d),
    float32, without autograd; (K, 4) for y (K, M, d) against x (K, N, d) or
    a shared x (N, d). CPU tensors take the plain version; CUDA tensors
    launch the kernel once for all three means of every trial."""
    if x.device.type == "cpu":
        return mmd_term_ref(x, y)
    return _launch("mmd_term_f32", x, y)


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


class MMDTerm(torch.autograd.Function):
    """MMD(x, y) = mean(x, x) + mean(y, y) - 2 mean(x, y) as one Function:
    the forward is one launch for all three means (of every trial), the
    backward is ``_kmd_bwd``'s closed form, in batched products with a trial
    axis, for the means whose inputs need gradients. A self mean's two sides
    sum to 2 coef (a * rowsum(K) - K a) with one K = gaussian_kernel(a, a),
    coef = -2 / (n^2 d^2)."""

    @staticmethod
    def forward(ctx, x, y):
        ctx.save_for_backward(x, y)
        return mmd_term_forward(x, y)[..., 3]

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        (n, d), m = x.shape[-2:], y.shape[-2]
        d2 = d * float(d)
        need_x, need_y = ctx.needs_input_grad
        dx = dy = None
        if not (need_x or need_y):
            return dx, dy
        g = g.reshape(*g.shape, 1, 1)  # one value per trial
        kxy = gaussian_kernel(x, y)
        cross = g * (-2.0 / (n * m * d2)) * -2.0  # the -2 mean(x, y) part
        if need_x:
            kxx = gaussian_kernel(x, x)
            dx = (g * (-4.0 / (n * n * d2)) * (x * kxx.sum(dim=-1, keepdim=True) - kxx @ x)
                  + cross * (x * kxy.sum(dim=-1, keepdim=True) - kxy @ y))
            if dx.dim() > x.dim():  # an x shared by the trials
                dx = dx.sum(dim=0)
        if need_y:
            kyy = gaussian_kernel(y, y)
            dy = (g * (-4.0 / (m * m * d2)) * (y * kyy.sum(dim=-1, keepdim=True) - kyy @ y)
                  + cross * (y * kxy.sum(dim=-2).unsqueeze(-1) - kxy.mT @ x))
        return dx, dy


def compute_mmd_fused(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """MMD(x, y) from the three kernel means, one launch on the card,
    differentiable; the counterpart of ``mmd_kernel.py::compute_mmd_pallas``."""
    return MMDTerm.apply(x, y)


def mmd_loss_fused(z: torch.Tensor, x_hat: torch.Tensor, x: torch.Tensor,
                   prior: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None,
                   n_prior_samples: int = N_PRIOR_SAMPLES) -> torch.Tensor:
    """``ops.losses.mmd_loss`` with the MMD through kernel B3; the counterpart
    of ``mmd_kernel.py::mmd_loss_pallas``."""
    prior = prior_or_draw(z, prior, generator, n_prior_samples)
    return compute_mmd_fused(prior, z) + recon_mse(x_hat, x)
