"""Tests of the port that need the CUDA card; they skip where there is none.

This file imports neither JAX nor the JAX package, so it also runs on a card
machine without them:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q``.

Tolerance for kernel against plain version: rtol=1e-4, atol=1e-4 (f32; the
kernel and cuBLAS sum the product in different orders; TF32 is off)."""

import pytest
import torch

from flexynesis_torch.kernels.fused_linear import (
    fused_linear_bn_relu_eval,
    fused_linear_bn_relu_eval_ref,
)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(B, F, H, device):
    g = torch.Generator().manual_seed(B + F + H)
    x = torch.randn(B, F, generator=g)
    w = (torch.rand(F, H, generator=g) * 2 - 1) / F ** 0.5
    vec = [torch.randn(H, generator=g) * 0.1 for _ in range(4)]
    rv = torch.rand(H, generator=g) + 0.5
    return [t.to(device) for t in (x, w, vec[0], 1 + vec[1], vec[2], vec[3], rv)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,F,H", [(1, 1, 1), (5, 37, 19), (37, 129, 67),
                                   (130, 300, 257), (64, 2000, 600)])
def test_kernel_matches_plain_version(card, B, F, H):
    args = _inputs(B, F, H, card)
    before = fused_linear_bn_relu_eval.launches
    y = fused_linear_bn_relu_eval(*args)
    torch.cuda.synchronize()
    assert fused_linear_bn_relu_eval.launches == before + 1
    torch.testing.assert_close(y, fused_linear_bn_relu_eval_ref(*args),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_kernel_rejects_bad_operands(card):
    x, w, *vec = _inputs(8, 16, 4, card)
    with pytest.raises(TypeError):
        fused_linear_bn_relu_eval(x.double(), w, *vec)
    with pytest.raises(ValueError):
        fused_linear_bn_relu_eval(x, w.t().contiguous().t(), *vec)
    with pytest.raises(ValueError):
        fused_linear_bn_relu_eval(x, w[:, :3].contiguous(), *vec)
