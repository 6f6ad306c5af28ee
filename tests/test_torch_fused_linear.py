"""Kernel B2 of the port (flexynesis_torch.kernels.fused_linear) against the
JAX package's Pallas kernel, run in interpret mode on the CPU as
tests/test_pallas_kernels.py runs it. On CPU tensors the wrapper takes its
plain version and launches nothing.

Tolerance: rtol=1e-4, atol=1e-5 (f32; the two sides sum the product in
different orders)."""

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
from flexynesis_torch.kernels.fused_linear import fused_linear_bn_relu_eval

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
