"""Kernel B1 of the port (training-mode fused Linear -> BatchNorm -> ReLU,
``flexynesis_torch.kernels.fused_linear.fused_linear_bn_relu``) against the JAX
package's Pallas kernel, run in interpret mode on the CPU as
tests/test_pallas_kernels.py runs it. On CPU tensors the wrapper takes its
plain version through the same autograd.Function (so the backward formula is
exercised here) and launches nothing.

Tolerances: forward and gradients rtol=1e-4, atol=1e-5 (f32; the two sides
sum in different orders); gradcheck in f64 at its defaults."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexynesis_tpu.ops.pallas.fused_linear import fused_linear_bn_relu as jax_fused
from flexynesis_torch.kernels.fused_linear import (
    fused_linear_bn_relu,
    fused_linear_bn_relu_forward,
    fused_linear_bn_relu_ref,
)

TOL = dict(rtol=1e-4, atol=1e-5)
SHAPES = [(1, 7, 5), (5, 37, 19), (24, 130, 300), (70, 33, 65)]


def make_inputs(seed, B, F, H):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, F)).astype(np.float32)
    w = (rng.uniform(-1, 1, size=(F, H)) / np.sqrt(F)).astype(np.float32)
    b = rng.normal(0, 0.1, H).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, H).astype(np.float32)
    beta = rng.normal(0, 0.1, H).astype(np.float32)
    gy = rng.normal(size=(B, H)).astype(np.float32)
    return (x, w, b, gamma, beta), gy


@pytest.mark.parametrize("B,F,H", SHAPES)
def test_forward_matches_pallas_kernel(B, F, H):
    arrays, _ = make_inputs(B * 1000 + H, B, F, H)
    before = fused_linear_bn_relu.launches
    y, mu, var = fused_linear_bn_relu(*(torch.from_numpy(a) for a in arrays))
    ref = jax_fused(*(jnp.asarray(a) for a in arrays))
    for got, want in zip((y, mu, var), ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert fused_linear_bn_relu.launches == before
    if B == 1:  # one row: zero variance, as in JAX
        assert float(var.abs().max()) == 0.0


@pytest.mark.parametrize("B,F,H", SHAPES)
def test_gradients_match_jax_grad(B, F, H):
    arrays, gy = make_inputs(B * 7 + F, B, F, H)

    def jax_loss(x, w, b, gamma, beta):
        y, _, _ = jax_fused(x, w, b, gamma, beta)
        return jnp.sum(y * gy)

    want = jax.grad(jax_loss, argnums=(0, 1, 2, 3, 4))(*(jnp.asarray(a) for a in arrays))
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    y, _, _ = fused_linear_bn_relu(*ts)
    (y * torch.from_numpy(gy)).sum().backward()
    for t, w_ in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w_), rtol=1e-4, atol=1e-5)


def test_plain_version_returns_h_and_matches_forward():
    arrays, _ = make_inputs(3, 9, 12, 6)
    ts = [torch.from_numpy(a) for a in arrays]
    y, h, mu, var = fused_linear_bn_relu_forward(*ts)
    torch.testing.assert_close(h, ts[0] @ ts[1] + ts[2])
    ref = fused_linear_bn_relu_ref(*ts)
    for got, want in zip((y, h, mu, var), ref):
        torch.testing.assert_close(got, want)


def test_gradcheck_f64():
    g = torch.Generator().manual_seed(0)
    args = [torch.randn(s, dtype=torch.float64, generator=g).requires_grad_()
            for s in ((6, 5), (5, 4), (4,), (4,), (4,))]
    assert torch.autograd.gradcheck(
        lambda *a: fused_linear_bn_relu(*a, 1e-5)[0], args)


def test_statistics_carry_no_gradient():
    arrays, _ = make_inputs(1, 8, 6, 3)
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    y, mu, var = fused_linear_bn_relu(*ts)
    assert y.requires_grad and not mu.requires_grad and not var.requires_grad


def test_rejects_devices_without_a_kernel():
    arrays, _ = make_inputs(0, 4, 8, 3)
    with pytest.raises(ValueError, match="no kernel"):
        fused_linear_bn_relu(*(torch.from_numpy(a).to("meta") for a in arrays))
