"""Tests of the port that need the CUDA card (kernels B1, B2 and B3); they
skip where there is none.

This file imports neither JAX nor the JAX package, so it also runs on a card
machine without them:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q``.

Tolerance for kernel against plain version: rtol=1e-4, atol=1e-4 (f32; the
kernel and cuBLAS sum the product in different orders; TF32 is off). B3's
mean: rtol 1e-5, atol 1e-6 (one f32 mean near 1, the order of summation
differs); its gradients: rtol 1e-4, atol 1e-4 times the largest plain
gradient (they scale as 1 / (N M d^2)); an MMD (a difference of means near
1): rtol 1e-4, atol 2e-6."""

import pytest
import torch

from flexynesis_torch.kernels.fused_linear import (
    ROW_TILE,
    fused_linear_bn_relu,
    fused_linear_bn_relu_eval,
    fused_linear_bn_relu_eval_ref,
    fused_linear_bn_relu_forward,
    fused_linear_bn_relu_ref,
    plan_b1,
    plan_b2,
)
from flexynesis_torch.kernels.mmd import (
    GaussianKernelMean,
    compute_mmd_fused,
    gaussian_kernel_mean,
    gaussian_kernel_mean_ref,
    launches_per_call,
    mmd_term_forward,
    mmd_term_ref,
)
from flexynesis_torch.ops.fused_mlp import FusedMLP
from flexynesis_torch.ops.losses import compute_mmd


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


# kernel B2: ragged edges, one row, no depth, and an F and H whose rows take
# 4-byte copies; each one launch and the same bits on repeat
@pytest.mark.cuda
@pytest.mark.parametrize("B,F,H", [(1, 1, 1), (5, 37, 19), (37, 129, 67),
                                   (130, 300, 257), (64, 2000, 600), (64, 1999, 601),
                                   (1, 2000, 600), (64, 0, 5)])
def test_kernel_matches_plain_version(card, B, F, H):
    args = _inputs(B, F, H, card)
    before = fused_linear_bn_relu_eval.launches
    y = fused_linear_bn_relu_eval(*args)
    torch.cuda.synchronize()
    assert fused_linear_bn_relu_eval.launches == before + 1
    torch.testing.assert_close(y, fused_linear_bn_relu_eval_ref(*args),
                               rtol=1e-4, atol=1e-4)
    assert torch.equal(y, fused_linear_bn_relu_eval(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("split,B,F,H", [(1, 64, 64, 16), (2, 64, 128, 600), (4, 64, 256, 600),
                                         (8, 64, 2000, 600), (8, 64, 1000, 300),
                                         (8, 400, 2000, 600), (8, 500, 1000, 300),
                                         (2, 2000, 2000, 600), (4, 2000, 1000, 300),
                                         (1, 2000, 64, 16), (8, 64, 1999, 601)])
def test_b2_reaches_each_cluster_size(card, split, B, F, H):
    assert plan_b2(B, F, H, torch.cuda.get_device_properties(card).multi_processor_count
                   ).split == split
    args = _inputs(B, F, H, card)
    before = fused_linear_bn_relu_eval.launches
    y = fused_linear_bn_relu_eval(*args)
    again = fused_linear_bn_relu_eval(*args)
    torch.cuda.synchronize()
    assert fused_linear_bn_relu_eval.launches == before + 2  # one launch per call
    torch.testing.assert_close(y, fused_linear_bn_relu_eval_ref(*args), rtol=1e-4, atol=1e-4)
    assert torch.equal(y, again)  # fixed cluster order


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
# (B > 64, partial statistics merged by a second launch), every cluster size
# and an F and H whose rows take 4-byte copies
B1_SHAPES = [(1, 1, 1), (5, 37, 19), (37, 129, 67), (64, 2000, 600), (65, 7, 33),
             (130, 300, 257), (2100, 64, 16), (64, 1999, 601), (1, 2000, 600),
             (64, 0, 5)]


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
@pytest.mark.parametrize("split,B,F,H", [(1, 64, 64, 16), (2, 64, 128, 600), (4, 64, 256, 600),
                                         (8, 64, 1000, 300), (4, 128, 2000, 600),
                                         (2, 37, 129, 67), (8, 64, 1001, 299)])
def test_b1_reaches_each_cluster_size(card, split, B, F, H):
    assert plan_b1(B, F, H, torch.cuda.get_device_properties(card).multi_processor_count
                   ).split == split
    x, w, b, gamma, beta, _, _ = _inputs(B, F, H, card)
    out = fused_linear_bn_relu_forward(x, w, b, gamma, beta)
    for got, want in zip(out, fused_linear_bn_relu_ref(x, w, b, gamma, beta)):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    again = fused_linear_bn_relu_forward(x, w, b, gamma, beta)
    assert all(torch.equal(a, c) for a, c in zip(out, again))  # fixed cluster order


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


def _trial_inputs(K, B, F, H, per_trial, device):
    """x (K, B, F) or one (B, F), w (K, F, H), b, gamma, beta, rm, rv (K, H)."""
    g = torch.Generator().manual_seed(K * 100 + B + F + H)
    x = torch.randn(*((K,) if per_trial else ()), B, F, generator=g)
    w = (torch.rand(K, F, H, generator=g) * 2 - 1) / max(F, 1) ** 0.5
    vec = [torch.randn(K, H, generator=g) * 0.1 for _ in range(4)]
    rv = torch.rand(K, H, generator=g) + 0.5
    return [t.to(device) for t in (x, w, vec[0], 1 + vec[1], vec[2], vec[3], rv)]


# the trial axis: 16 trials of the headline blocks (x shared and x per
# trial), a ragged K = 3, and B > 64 for B1's merge launch
TRIAL_SHAPES = [(16, 64, 2000, 600, False), (16, 64, 1000, 300, True),
                (16, 64, 64, 16, True), (16, 400, 2000, 600, False), (3, 37, 129, 67, True),
                (3, 130, 129, 67, False), (2, 64, 1999, 601, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("K,B,F,H,per_trial", TRIAL_SHAPES)
def test_b2_trial_axis_matches_plain_version(card, K, B, F, H, per_trial):
    args = _trial_inputs(K, B, F, H, per_trial, card)
    before = fused_linear_bn_relu_eval.launches
    y = fused_linear_bn_relu_eval(*args)
    torch.cuda.synchronize()
    assert fused_linear_bn_relu_eval.launches == before + 1  # one launch for K trials
    assert y.shape == (K, B, H)
    torch.testing.assert_close(y, fused_linear_bn_relu_eval_ref(*args), rtol=1e-4, atol=1e-4)
    assert torch.equal(y, fused_linear_bn_relu_eval(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("K,B,F,H,per_trial", TRIAL_SHAPES)
def test_b1_trial_axis_matches_plain_version(card, K, B, F, H, per_trial):
    x, w, b, gamma, beta, _, _ = _trial_inputs(K, B, F, H, per_trial, card)
    before = fused_linear_bn_relu.launches
    out = fused_linear_bn_relu_forward(x, w, b, gamma, beta)
    torch.cuda.synchronize()
    assert fused_linear_bn_relu.launches == before + (1 if B <= ROW_TILE else 2)
    for got, want in zip(out, fused_linear_bn_relu_ref(x, w, b, gamma, beta)):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    again = fused_linear_bn_relu_forward(x, w, b, gamma, beta)
    assert all(torch.equal(a, c) for a, c in zip(out, again))


@pytest.mark.cuda
@pytest.mark.parametrize("K,B,F,H,per_trial", [(4, 64, 300, 90, False), (3, 70, 129, 67, True)])
def test_b1_trial_axis_gradients_match_autograd(card, K, B, F, H, per_trial):
    base = _trial_inputs(K, B, F, H, per_trial, card)[:5]
    gy = torch.randn(K, B, H, device=card, generator=torch.Generator(card).manual_seed(1))
    grads = []
    for fn in (lambda *a: fused_linear_bn_relu(*a)[0],
               lambda *a: fused_linear_bn_relu_ref(*a)[0]):
        args = [t.clone().requires_grad_() for t in base]
        (fn(*args) * gy).sum().backward()
        grads.append([a.grad for a in args])
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("B,F,H", [(64, 2000, 600), (400, 1000, 300), (37, 129, 67)])
def test_one_trial_gives_the_bits_of_the_call_without_the_axis(card, B, F, H):
    x, w, b, gamma, beta, rm, rv = _trial_inputs(1, B, F, H, False, card)
    flat = [w[0], b[0], gamma[0], beta[0], rm[0], rv[0]]
    assert torch.equal(fused_linear_bn_relu_eval(x, w, b, gamma, beta, rm, rv)[0],
                       fused_linear_bn_relu_eval(x, *flat))
    for a, c in zip(fused_linear_bn_relu_forward(x, w, b, gamma, beta),
                    fused_linear_bn_relu_forward(x, *flat[:4])):
        assert torch.equal(a[0], c)


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


# kernel B3: one tile and several, each one launch (the fixed-order reduction
# runs in the block that draws the last ticket)
B3_SHAPES = [(1, 1, 1), (37, 129, 17), (64, 64, 64), (200, 64, 64), (200, 200, 64),
             (400, 400, 64), (1000, 70, 130)]


def _b3_inputs(N, M, d, device):
    g = torch.Generator().manual_seed(N * 3 + M + d)
    return torch.randn(N, d, generator=g).to(device), torch.randn(M, d, generator=g).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("N,M,d", B3_SHAPES)
def test_b3_matches_plain_version_bit_for_bit_between_calls(card, N, M, d):
    x, y = _b3_inputs(N, M, d, card)
    before = gaussian_kernel_mean.launches
    out = gaussian_kernel_mean(x, y)
    torch.cuda.synchronize()
    assert gaussian_kernel_mean.launches == before + launches_per_call(N, M)
    torch.testing.assert_close(out, gaussian_kernel_mean_ref(x, y), rtol=1e-5, atol=1e-6)
    assert torch.equal(out, gaussian_kernel_mean(x, y))


@pytest.mark.cuda
@pytest.mark.parametrize("N,M,d", [(200, 64, 64), (37, 129, 17)])
def test_b3_gradients_match_autograd_through_plain_version(card, N, M, d):
    x, y = _b3_inputs(N, M, d, card)
    cases = [(GaussianKernelMean.apply, gaussian_kernel_mean_ref, (x, y)),
             (lambda a: GaussianKernelMean.apply(a, a), lambda a: gaussian_kernel_mean_ref(a, a),
              (y,)),
             (compute_mmd_fused, compute_mmd, (x, y)),
             (lambda a: compute_mmd_fused(x, a), lambda a: compute_mmd(x, a), (y,))]
    for fused, plain, inputs in cases:
        grads = []
        for fn in (fused, plain):
            leaves = [t.clone().requires_grad_() for t in inputs]
            fn(*leaves).backward()
            grads.append([t.grad for t in leaves])
        for got, want in zip(*grads):
            torch.testing.assert_close(got, want, rtol=1e-4,
                                       atol=1e-4 * float(want.abs().max()))


@pytest.mark.cuda
def test_b3_rejects_bad_operands(card):
    x, y = _b3_inputs(8, 9, 4, card)
    with pytest.raises(TypeError):
        gaussian_kernel_mean(x.double(), y)
    with pytest.raises(ValueError):
        gaussian_kernel_mean(x, y[:, :3])
    with pytest.raises(ValueError):
        gaussian_kernel_mean(x.t().contiguous().t(), y)
    with pytest.raises(ValueError):
        gaussian_kernel_mean(x[:0], y)


MMD_TOL = dict(rtol=1e-4, atol=2e-6)


def _check_term(got, x, y):
    want = mmd_term_ref(x, y)
    torch.testing.assert_close(got[:3], want[:3], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got[3], want[3], **MMD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("N,M,d", [(200, 64, 64), (200, 400, 64), (1, 1, 1), (37, 129, 17),
                                   (65, 64, 64), (1000, 70, 130)])
def test_b3_mmd_term_is_one_launch_and_bit_for_bit(card, N, M, d):
    x, y = _b3_inputs(N, M, d, card)
    before = gaussian_kernel_mean.launches
    got = mmd_term_forward(x, y)
    torch.cuda.synchronize()
    assert gaussian_kernel_mean.launches == before + 1
    _check_term(got, x, y)
    assert torch.equal(got, mmd_term_forward(x, y))
    assert float(compute_mmd_fused(x, y)) == float(got[3])


@pytest.mark.cuda
def test_b3_ticket_resets_between_calls_of_any_shape(card):
    # one-tile and many-tile calls of both entry points back to back on one
    # stream and one workspace, with no synchronisation between them: each
    # launch must find the ticket at 0 and leave it so
    shapes = [(64, 64, 64), (400, 400, 64), (1, 1, 1), (4096, 300, 64), (37, 129, 17),
              (200, 64, 64), (64, 64, 64)]
    inputs = [_b3_inputs(*s, card) for s in shapes]
    runs = []
    for _ in range(2):
        before = gaussian_kernel_mean.launches
        runs.append([(gaussian_kernel_mean(x, y), mmd_term_forward(x, y)) for x, y in inputs])
        assert gaussian_kernel_mean.launches == before + 2 * len(shapes)
    torch.cuda.synchronize()
    for (x, y), (mean, term), (mean2, term2) in zip(inputs, *runs):
        torch.testing.assert_close(mean, gaussian_kernel_mean_ref(x, y), rtol=1e-5, atol=1e-6)
        _check_term(term, x, y)
        assert torch.equal(mean, mean2) and torch.equal(term, term2)


# kernel B3 with a trial axis: the prior shared by the trials (read at a
# trial stride of 0) or per trial; one launch for all trials, and each
# trial's bits those of a one-trial call on its slice
@pytest.mark.cuda
@pytest.mark.parametrize("K,N,M,d,per_trial", [(16, 200, 64, 64, False), (16, 200, 64, 64, True),
                                               (16, 200, 400, 64, False), (1, 200, 64, 64, True),
                                               (3, 37, 129, 17, True), (5, 1, 1, 1, False)])
def test_b3_trial_axis_matches_plain_version_and_single_calls(card, K, N, M, d, per_trial):
    g = torch.Generator().manual_seed(K + N + M + d)
    x = torch.randn(*((K,) if per_trial else ()), N, d, generator=g).to(card)
    y = torch.randn(K, M, d, generator=g).to(card)
    before = gaussian_kernel_mean.launches
    got = mmd_term_forward(x, y)
    torch.cuda.synchronize()
    assert gaussian_kernel_mean.launches == before + 1 and got.shape == (K, 4)
    for k in range(K):
        xk = x[k] if per_trial else x
        _check_term(got[k], xk, y[k])
        assert torch.equal(got[k], mmd_term_forward(xk, y[k]))
    assert torch.equal(got, mmd_term_forward(x, y))
    torch.testing.assert_close(compute_mmd_fused(x, y), got[:, 3], rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("per_trial", [False, True])
def test_b3_trial_axis_gradients_match_autograd(card, per_trial):
    g = torch.Generator().manual_seed(5)
    K, N, M, d = 4, 200, 64, 64
    x = torch.randn(*((K,) if per_trial else ()), N, d, generator=g).to(card)
    y = torch.randn(K, M, d, generator=g).to(card)
    w = torch.arange(1.0, K + 1.0, device=card)
    grads = []
    for fn in (compute_mmd_fused, compute_mmd):
        leaves = [t.clone().requires_grad_() for t in (x, y)]
        (fn(*leaves) * w).sum().backward()
        grads.append([t.grad for t in leaves])
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * float(want.abs().max()))


@pytest.mark.cuda
def test_b3_trial_axis_rejects_bad_operands(card):
    x, y = torch.randn(3, 20, 8, device=card), torch.randn(3, 9, 8, device=card)
    with pytest.raises(ValueError):
        mmd_term_forward(x[:2], y)  # trial counts differ
    with pytest.raises(ValueError):
        mmd_term_forward(x, y[0])  # a stacked prior against one batch
    with pytest.raises(ValueError):
        gaussian_kernel_mean(x, y)  # one mean takes no trial axis
    with pytest.raises(ValueError):
        mmd_term_forward(x, y[:0])
