"""Kernel B2 of the port (flexynesis_torch.kernels.fused_linear) against the
JAX package's Pallas kernel, run in interpret mode on the CPU as
tests/test_pallas_kernels.py runs it. On CPU tensors the wrapper takes its
plain version and launches nothing.

Tolerance: rtol=1e-4, atol=1e-5 (f32; the two sides sum the product in
different orders).

The kernel's 3xTF32 arithmetic is emulated here in torch: each operand split
into two TF32 values, three products summed per 8-deep step in the kernel's
order, each 32-deep stage folded into the running sum by an f32 add. Against
the float64 product it must hold the card's tolerance, rtol=1e-4 and
atol=1e-4, which one TF32 pass misses."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexynesis_tpu.ops.pallas.fused_linear import (
    fused_linear_bn_relu_eval as jax_fused_eval,
)
from flexynesis_torch.kernels.fused_linear import (
    B2_K_STAGE,
    fused_linear_bn_relu_eval,
    fused_linear_bn_relu_eval_ref,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def make_inputs(seed, B, F, H):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, F)).astype(np.float32)
    w = (rng.uniform(-1, 1, size=(F, H)) / np.sqrt(F)).astype(np.float32)
    b = rng.normal(0, 0.1, H).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, H).astype(np.float32)
    beta = rng.normal(0, 0.1, H).astype(np.float32)
    rm = rng.normal(0, 0.2, H).astype(np.float32)
    rv = rng.uniform(0.5, 1.5, H).astype(np.float32)
    return x, w, b, gamma, beta, rm, rv


@pytest.mark.parametrize("B,F,H", [(5, 37, 19), (24, 130, 300)])
def test_matches_pallas_kernel(B, F, H):
    arrays = make_inputs(B * 1000 + H, B, F, H)
    before = fused_linear_bn_relu_eval.launches
    y = fused_linear_bn_relu_eval(*(torch.from_numpy(a) for a in arrays))
    ref = jax_fused_eval(*(jnp.asarray(a) for a in arrays))
    assert y.shape == (B, H)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)
    assert fused_linear_bn_relu_eval.launches == before


def test_rejects_devices_without_a_kernel():
    arrays = [torch.from_numpy(a).to("meta") for a in make_inputs(0, 4, 8, 3)]
    with pytest.raises(ValueError, match="no kernel"):
        fused_linear_bn_relu_eval(*arrays)


def test_imports_without_triton_or_nvcc():
    code = (
        "import sys, torch\n"
        "from flexynesis_torch.kernels import fused_linear, build\n"
        "assert 'triton' not in sys.modules\n"
        "assert not build._loaded\n"
        "x = torch.ones(3, 4); w = torch.ones(4, 2); v = torch.ones(2)\n"
        "y = fused_linear.fused_linear_bn_relu_eval(x, w, v, v, v, v, v)\n"
        "assert y.shape == (3, 2) and fused_linear.fused_linear_bn_relu_eval.launches == 0\n"
    )
    env = dict(os.environ, PATH="/nonexistent",
               PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def tf32(t):
    """Round f32 to TF32 (10 mantissa bits) to nearest, ties away from zero,
    as ``cvt.rna.tf32.f32`` does: add half of the dropped 13 bits to the
    magnitude, then clear them."""
    return ((t.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def emulated_product(x, w, passes):
    """x @ w as the kernel's main loop sums it: per 8-deep step the products
    ``passes`` names (operand halves), summed in that order into a stage sum
    that an f32 add folds into the running sum every stage (32 of depth)."""
    halves = {}
    for name, t in (("x", x), ("w", w)):
        big = tf32(t)
        halves[name] = (big, tf32(t - big))
    acc = torch.zeros(x.shape[0], w.shape[1])
    for k0 in range(0, x.shape[1], B2_K_STAGE):
        stage = torch.zeros_like(acc)
        for k in range(k0, min(k0 + B2_K_STAGE, x.shape[1]), 8):
            for a, b in passes:
                stage += halves["x"][a][:, k:k + 8] @ halves["w"][b][k:k + 8]
        acc += stage
    return acc


THREE_TF32 = ((1, 0), (0, 1), (0, 0))  # small*big, big*small, then big*big
ONE_TF32 = ((0, 0),)


def test_tf32_rounding_matches_the_hardware_rule():
    one = 1 + 2.0 ** -10  # the smallest step above 1 at 10 mantissa bits
    t = torch.tensor([1 + 2.0 ** -11, 1 + 2.0 ** -12, -(1 + 2.0 ** -11), 1 + 3 * 2.0 ** -11,
                      one], dtype=torch.float32)
    want = torch.tensor([one, 1.0, -one, 1 + 2 * 2.0 ** -10, one], dtype=torch.float32)
    assert torch.equal(tf32(t), want)
    x = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    assert (tf32(x).view(torch.int32) & 0x1FFF).eq(0).all()
    assert ((tf32(x) - x).abs() <= x.abs() * 2.0 ** -11).all()


def test_three_tf32_holds_the_card_tolerance_at_the_encoder_depth():
    # the gex encoder's depth and width, with the largest BN factor
    # gamma * rsqrt(running_var + eps) near 2.1, as chip_smoke.py's inputs
    B, F, H = 256, 2000, 600
    x, w, b, gamma, beta, rm, rv = (torch.from_numpy(a) for a in make_inputs(7, B, F, H))
    want = fused_linear_bn_relu_eval_ref(*(t.double() for t in (x, w, b, gamma, beta, rm, rv)))

    def epilogue(h):
        return torch.relu((h + b - rm) * torch.rsqrt(rv + 1e-5) * gamma + beta).double()

    three = epilogue(emulated_product(x, w, THREE_TF32))
    one = epilogue(emulated_product(x, w, ONE_TF32))
    torch.testing.assert_close(three, want, rtol=1e-4, atol=1e-4)
    assert not torch.allclose(one, want, rtol=1e-4, atol=1e-4)
    # near f32's own error, and far below one pass's
    f32_err = float((fused_linear_bn_relu_eval_ref(x, w, b, gamma, beta, rm, rv).double()
                     - want).abs().max())
    three_err, one_err = (float((y - want).abs().max()) for y in (three, one))
    assert three_err < 4 * f32_err and one_err > 100 * three_err
