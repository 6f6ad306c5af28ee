"""Kernel B3 of the port (``flexynesis_torch.kernels.mmd``, the Gaussian-kernel
mean of the VAE-MMD loss) and the plain MMD of ``ops/losses.py`` against the
JAX package: the Pallas ``gaussian_kernel_mean`` and ``compute_mmd_pallas``,
run in interpret mode on the CPU as tests/test_pallas_kernels.py runs them,
and ``ops/losses.py::compute_mmd``. On CPU tensors the wrapper takes its plain
version through the same autograd.Function, so the closed-form backward is
exercised here, and it launches nothing.

Tolerances (f32):
* a kernel mean (values near 1): rtol 1e-5, atol 1e-6; only the order of
  summation differs, and the Pallas kernel pads d to 128 with zeros;
* an MMD, a difference of three means near 1 (values near 1e-3): atol 2e-6,
  rtol 1e-4, since the cancellation turns the means' rounding into an
  absolute error;
* gradients, which scale as 1 / (N M d^2): rtol 1e-4 and atol 1e-4 times the
  largest reference gradient;
* gradcheck in f64 at its defaults."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexynesis_tpu.ops import losses as jax_losses
from flexynesis_tpu.ops.pallas import mmd_kernel as jax_mmd
from flexynesis_torch.kernels.mmd import (
    GaussianKernelMean,
    MMDTerm,
    compute_mmd_fused,
    gaussian_kernel_mean,
    gaussian_kernel_mean_ref,
    launches_per_call,
    mmd_loss_fused,
    mmd_term_forward,
)
from flexynesis_torch.ops.losses import compute_mmd, mmd_loss
from flexynesis_torch.ops.mlp import standard_normal

MEAN_TOL = dict(rtol=1e-5, atol=1e-6)
MMD_TOL = dict(rtol=1e-4, atol=2e-6)
# (N, M, d): the training shapes at a small latent, a ragged d, one row
SHAPES = [(20, 33, 16), (64, 64, 8), (37, 129, 17), (1, 5, 3)]


def make(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=s) * scale).astype(np.float32) for s in shapes]


def _grad_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4,
                               atol=1e-4 * float(np.abs(want).max()))


@pytest.mark.parametrize("N,M,d", SHAPES)
def test_kernel_mean_matches_pallas_kernel(N, M, d):
    x, y = make(N * 100 + d, (N, d), (M, d))
    before = gaussian_kernel_mean.launches
    ours = gaussian_kernel_mean(torch.from_numpy(x), torch.from_numpy(y))
    assert gaussian_kernel_mean.launches == before  # the CPU path launches nothing
    want = float(jax_mmd.gaussian_kernel_mean(jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_allclose(float(ours), want, **MEAN_TOL)
    # and the exact differences the Pallas docstring names, in float64
    sq = ((x[:, None, :].astype(np.float64) - y[None]) ** 2).sum(-1)
    np.testing.assert_allclose(float(ours), np.exp(-sq / d**2).mean(), **MEAN_TOL)


@pytest.mark.parametrize("N,M,d", SHAPES)
def test_mmd_matches_pallas_and_xla_mmd(N, M, d):
    x, y = make(N + M + d, (N, d), (M, d), scale=1.3)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    want_pallas = float(jax_mmd.compute_mmd_pallas(jx, jy))
    want_xla = float(jax_losses.compute_mmd(jx, jy))
    np.testing.assert_allclose(float(compute_mmd_fused(tx, ty)), want_pallas, **MMD_TOL)
    np.testing.assert_allclose(float(compute_mmd(tx, ty)), want_xla, **MMD_TOL)


@pytest.mark.parametrize("N,M,d", SHAPES)
def test_kernel_mean_gradients_match_jax_grad(N, M, d):
    x, y = make(N * 3 + M, (N, d), (M, d))
    want = jax.grad(jax_mmd.gaussian_kernel_mean_diff, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(y))
    tx, ty = (torch.from_numpy(a).requires_grad_() for a in (x, y))
    GaussianKernelMean.apply(tx, ty).backward()
    _grad_close(tx.grad.numpy(), want[0])
    _grad_close(ty.grad.numpy(), want[1])


@pytest.mark.parametrize("N,d", [(20, 16), (37, 17), (1, 3)])
def test_self_term_sums_both_gradients_as_jax_does(N, d):
    (z,) = make(N + d, (N, d))
    want = jax.grad(lambda a: jax_mmd.gaussian_kernel_mean_diff(a, a))(jnp.asarray(z))
    tz = torch.from_numpy(z).requires_grad_()
    GaussianKernelMean.apply(tz, tz).backward()
    _grad_close(tz.grad.numpy(), want)


@pytest.mark.parametrize("N,M,d", SHAPES)
def test_mmd_gradients_match_jax_grad(N, M, d):
    x, y = make(N * 11 + d, (N, d), (M, d))
    want = jax.grad(jax_mmd.compute_mmd_pallas, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    tx, ty = (torch.from_numpy(a).requires_grad_() for a in (x, y))
    compute_mmd_fused(tx, ty).backward()
    _grad_close(tx.grad.numpy(), want[0])
    _grad_close(ty.grad.numpy(), want[1])


# the MMD term as one Function (one launch on the card): the value, the three
# means beside it, and the gradients of every input that needs them, against
# compute_mmd_pallas in interpret mode; tolerances MMD_TOL, MEAN_TOL and
# _grad_close's (module docstring)
@pytest.mark.parametrize("N,M,d", SHAPES + [(200, 64, 8)])
def test_mmd_term_matches_compute_mmd_pallas(N, M, d):
    x, y = make(N * 5 + M + d, (N, d), (M, d), scale=1.1)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    before = gaussian_kernel_mean.launches
    terms = mmd_term_forward(tx, ty)
    assert gaussian_kernel_mean.launches == before  # the CPU path launches nothing
    for got, (a, b) in zip(terms[:3], ((jx, jx), (jy, jy), (jx, jy))):
        np.testing.assert_allclose(float(got), float(jax_mmd.gaussian_kernel_mean(a, b)),
                                   **MEAN_TOL)
    want = float(jax_mmd.compute_mmd_pallas(jx, jy))
    np.testing.assert_allclose(float(terms[3]), want, **MMD_TOL)
    np.testing.assert_allclose(float(MMDTerm.apply(tx, ty)), want, **MMD_TOL)
    grads = jax.grad(jax_mmd.compute_mmd_pallas, argnums=(0, 1))(jx, jy)
    for needs in ((True, True), (False, True), (True, False)):
        leaves = [torch.from_numpy(a).requires_grad_(n) for a, n in zip((x, y), needs)]
        MMDTerm.apply(*leaves).backward()
        for leaf, n, w in zip(leaves, needs, grads):
            if n:
                _grad_close(leaf.grad.numpy(), w)
            else:
                assert leaf.grad is None


def test_gradcheck_f64():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(6, 5, dtype=torch.float64, generator=g).requires_grad_()
    y = torch.randn(4, 5, dtype=torch.float64, generator=g).requires_grad_()
    assert torch.autograd.gradcheck(GaussianKernelMean.apply, (x, y))
    assert torch.autograd.gradcheck(lambda a: GaussianKernelMean.apply(a, a), (y,))
    assert torch.autograd.gradcheck(compute_mmd_fused, (x, y))
    assert torch.autograd.gradcheck(lambda a: MMDTerm.apply(x.detach(), a), (y,))


@pytest.mark.parametrize("fused", [False, True])
def test_mmd_loss_matches_jax_with_the_same_prior(fused):
    z, x_hat, x = make(5, (24, 12), (24, 30), (24, 30))
    x_hat = 1 / (1 + np.exp(-x_hat))
    key = jax.random.key(7)
    prior = np.asarray(jax.random.normal(key, (200, 12), jnp.float32))
    jax_fn = jax_mmd.mmd_loss_pallas if fused else jax_losses.mmd_loss
    want = float(jax_fn(key, jnp.asarray(z), jnp.asarray(x_hat), jnp.asarray(x)))
    port_fn = mmd_loss_fused if fused else mmd_loss
    got = port_fn(*(torch.from_numpy(a) for a in (z, x_hat, x)), prior=torch.from_numpy(prior))
    np.testing.assert_allclose(float(got), want, **MMD_TOL)


@pytest.mark.parametrize("port_fn", [mmd_loss, mmd_loss_fused])
def test_mmd_loss_draws_its_prior_from_the_generator(port_fn):
    z, x_hat, x = (torch.from_numpy(a) for a in make(2, (10, 4), (10, 6), (10, 6)))
    drawn = port_fn(z, x_hat, x, generator=torch.Generator().manual_seed(3))
    prior = standard_normal((200, 4), torch.Generator().manual_seed(3), "cpu")
    assert float(drawn) == float(port_fn(z, x_hat, x, prior=prior))
    with pytest.raises(ValueError, match="Generator"):
        port_fn(z, x_hat, x)


def test_plain_version_is_the_mean_of_the_kernel_matrix():
    x, y = (torch.from_numpy(a) for a in make(1, (9, 5), (7, 5)))
    from flexynesis_torch.ops.losses import gaussian_kernel

    K = gaussian_kernel(x, y)
    assert K.shape == (9, 7) and bool((K > 0).all() and (K <= 1).all())
    torch.testing.assert_close(gaussian_kernel_mean_ref(x, y), K.mean())


@pytest.mark.parametrize("n,m,want", [(64, 64, 1), (1, 1, 1), (65, 64, 1),
                                      (200, 200, 1), (64, 200, 1), (400, 400, 1)])
def test_launches_per_call(n, m, want):
    assert launches_per_call(n, m) == want


def test_rejects_devices_without_a_kernel():
    x, y = (torch.from_numpy(a).to("meta") for a in make(0, (4, 3), (5, 3)))
    with pytest.raises(ValueError, match="no kernel"):
        gaussian_kernel_mean(x, y)
