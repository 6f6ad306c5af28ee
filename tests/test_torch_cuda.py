"""Tests of the port that need the CUDA card (kernels B1 and B2); they skip
where there is none.

This file imports neither JAX nor the JAX package, so it also runs on a card
machine without them:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q``.

Tolerance for kernel against plain version: rtol=1e-4, atol=1e-4 (f32; the
kernel and cuBLAS sum the product in different orders; TF32 is off)."""

import pytest
import torch

from flexynesis_torch.kernels.fused_linear import (
    ROW_TILE,
    fused_linear_bn_relu,
    fused_linear_bn_relu_eval,
    fused_linear_bn_relu_eval_ref,
    fused_linear_bn_relu_forward,
    fused_linear_bn_relu_ref,
)
from flexynesis_torch.ops.fused_mlp import FusedMLP


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


# kernel B1: the shapes cover one row tile (B <= 64) and the split reduction
# (B > 64, partial statistics merged by a second launch)
B1_SHAPES = [(1, 1, 1), (5, 37, 19), (37, 129, 67), (64, 2000, 600), (65, 7, 33),
             (130, 300, 257), (2100, 64, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,F,H", B1_SHAPES)
def test_b1_matches_plain_version(card, B, F, H):
    x, w, b, gamma, beta, _, _ = _inputs(B, F, H, card)
    before = fused_linear_bn_relu.launches
    out = fused_linear_bn_relu_forward(x, w, b, gamma, beta)
    torch.cuda.synchronize()
    # the merge of the split reduction is a second launch
    assert fused_linear_bn_relu.launches == before + (1 if B <= ROW_TILE else 2)
    for got, want in zip(out, fused_linear_bn_relu_ref(x, w, b, gamma, beta)):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    again = fused_linear_bn_relu_forward(x, w, b, gamma, beta)
    assert all(torch.equal(a, c) for a, c in zip(out, again))  # fixed merge order


@pytest.mark.cuda
@pytest.mark.parametrize("B,F,H", [(64, 2000, 600), (130, 300, 257)])
def test_b1_gradients_match_autograd_through_plain_version(card, B, F, H):
    base = _inputs(B, F, H, card)[:5]
    gy = torch.randn(B, H, device=card, generator=torch.Generator(card).manual_seed(1))
    grads = []
    for fn in (lambda *a: fused_linear_bn_relu(*a)[0],
               lambda *a: fused_linear_bn_relu_ref(*a)[0]):
        args = [t.clone().requires_grad_() for t in base]
        (fn(*args) * gy).sum().backward()
        grads.append([a.grad for a in args])
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_fused_block_trains_the_same_on_the_card(card):
    cpu = FusedMLP(40, 12, 3, dropout_rate=0.0)
    cpu.reset_parameters(torch.Generator().manual_seed(0))
    gpu = FusedMLP(40, 12, 3, dropout_rate=0.0).to(card)
    gpu.load_state_dict(cpu.state_dict())
    cpu.train()
    gpu.train()
    x = torch.randn(70, 40, generator=torch.Generator().manual_seed(2))
    y_cpu = cpu(x, torch.Generator())
    y_gpu = gpu(x.to(card), torch.Generator(card))
    torch.testing.assert_close(y_gpu.cpu(), y_cpu, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(gpu.running_var.cpu(), cpu.running_var, rtol=1e-4, atol=1e-5)
