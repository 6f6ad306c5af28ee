"""Tests of the port that need the CUDA card (kernels B1, B2 and B3, and the
SR-bf16 Adam kernel); they skip where there is none.

This file imports neither JAX nor the JAX package, so it also runs on a card
machine without them:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q``.

Tolerance for kernel against plain version: rtol=1e-4, atol=1e-4 (f32; the
kernel and cuBLAS sum the product in different orders; TF32 is off). B3's
mean: rtol 1e-5, atol 1e-6 (one f32 mean near 1, the order of summation
differs); its gradients: rtol 1e-4, atol 1e-4 times the largest plain
gradient (they scale as 1 / (N M d^2)); an MMD (a difference of means near
1): rtol 1e-4, atol 2e-6. The SR-bf16 Adam kernel: bit for bit, against
the plain chain with its fused multiply-adds rounded once (and, where real
gradients clip, its norm summed in float64), as the kernel computes them."""

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


# the fine-tuning slice: the covariate encoder (F = H = 2, 4-byte copies),
# the early-fusion encoder (gex 2000 + cnv 1000 + age, hidden 900) at the
# 64-row batch and the 400-row validation, and the 45-trial grid with x per
# trial (each fold its rows: 32-row steps, 20-row validations)
SLICE_SHAPES = [(64, 2, 2), (400, 2, 2), (64, 3001, 900), (400, 3001, 900)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,F,H", SLICE_SHAPES)
def test_slice_shapes_match_plain_versions(card, B, F, H):
    args = _inputs(B, F, H, card)
    before = (fused_linear_bn_relu.launches, fused_linear_bn_relu_eval.launches)
    out = fused_linear_bn_relu_forward(*args[:5])
    y = fused_linear_bn_relu_eval(*args)
    torch.cuda.synchronize()
    assert fused_linear_bn_relu.launches == before[0] + (1 if B <= ROW_TILE else 2)
    assert fused_linear_bn_relu_eval.launches == before[1] + 1
    for got, want in zip(out, fused_linear_bn_relu_ref(*args[:5])):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(y, fused_linear_bn_relu_eval_ref(*args), rtol=1e-4, atol=1e-4)
    assert all(torch.equal(a, c) for a, c in zip(out, fused_linear_bn_relu_forward(*args[:5])))
    assert torch.equal(y, fused_linear_bn_relu_eval(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("K,B,F,H", [(45, 32, 2000, 600), (45, 20, 2000, 600),
                                     (45, 32, 2, 2), (45, 20, 3001, 900)])
def test_grid_trial_axis_matches_plain_versions(card, K, B, F, H):
    args = _trial_inputs(K, B, F, H, True, card)
    before = (fused_linear_bn_relu.launches, fused_linear_bn_relu_eval.launches)
    out = fused_linear_bn_relu_forward(*args[:5])
    y = fused_linear_bn_relu_eval(*args)
    torch.cuda.synchronize()
    assert fused_linear_bn_relu.launches == before[0] + 1  # one launch for 45 trials
    assert fused_linear_bn_relu_eval.launches == before[1] + 1
    for got, want in zip(out, fused_linear_bn_relu_ref(*args[:5])):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(y, fused_linear_bn_relu_eval_ref(*args), rtol=1e-4, atol=1e-4)
    assert all(torch.equal(a, c) for a, c in zip(out, fused_linear_bn_relu_forward(*args[:5])))
    assert torch.equal(y, fused_linear_bn_relu_eval(*args))


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


# the analysis surface on the card against the CPU: CoxPH in float64 (the
# same Newton path; coefficients and standard errors within 1e-8 relative),
# the co-expression sweep (float32 Gram products in two summation orders:
# the same edges away from the threshold, scores within 1e-5) and KMeans
# (float64 Lloyd: the same labels, inertia within 1e-8 relative)
def _cox_table(seed=0, n=300, p=5):
    import numpy as np

    from flexynesis_torch.utils.csvio import Table

    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, p))
    t = np.ceil(4 * rng.exponential(np.exp(-(X[:, 0] - 0.5 * X[:, 1])))) / 4
    e = (rng.random(n) < 0.7).astype(float)
    return Table([f"s{i}" for i in range(n)], [f"x{i}" for i in range(p)] + ["t", "e"],
                 np.column_stack([X, t, e]))


@pytest.mark.cuda
def test_coxph_on_the_card_matches_the_cpu(card):
    from flexynesis_torch.utils.survival import CoxPH, build_cox_model

    table = _cox_table()
    got = CoxPH(penalizer=0.05, device="cuda").fit(table, "t", "e")
    want = CoxPH(penalizer=0.05, device="cpu").fit(table, "t", "e")
    torch.testing.assert_close(torch.as_tensor(got.params_), torch.as_tensor(want.params_),
                               rtol=1e-8, atol=0)
    torch.testing.assert_close(torch.as_tensor(got.standard_errors_),
                               torch.as_tensor(want.standard_errors_), rtol=1e-8, atol=0)
    _, m_card = build_cox_model(table, "t", "e", device="cuda")
    _, m_cpu = build_cox_model(table, "t", "e", device="cpu")
    torch.testing.assert_close(torch.as_tensor(m_card["cv_cindex"]),
                               torch.as_tensor(m_cpu["cv_cindex"]), rtol=1e-8, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["spearman", "pearson"])
def test_coexpression_sweep_on_the_card_matches_the_cpu(card, method):
    import numpy as np

    from flexynesis_torch.coexpression import build_network

    rng = np.random.default_rng(1)
    G, n = 3000, 120
    factors = rng.normal(size=(G // 10, n))
    X = np.repeat(factors, 10, axis=0) + 0.5 * rng.normal(size=(G, n))
    if method == "spearman":  # counts: ties in the ranks
        X = rng.poisson(np.exp(1.5 + 0.5 * X)).astype(np.float64)
    genes = [f"g{i}" for i in range(G)]
    kw = dict(method=method, correlation_threshold=0.5, top_k=5, block_size=1024)
    got, _ = build_network(genes, X, device="cuda", **kw)
    want, _ = build_network(genes, X, device="cpu", **kw)
    g = dict(zip(zip(got["GeneA"], got["GeneB"]), got["Score"]))
    w = dict(zip(zip(want["GeneA"], want["GeneB"]), want["Score"]))
    differ = set(g) ^ set(w)
    assert all(abs(abs(g.get(k, w.get(k))) - 0.5) < 1e-6 for k in differ), len(differ)
    common = sorted(set(g) & set(w))
    assert len(common) > 1000
    torch.testing.assert_close(torch.tensor([g[k] for k in common]),
                               torch.tensor([w[k] for k in common]), rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_kmeans_on_the_card_matches_the_cpu(card):
    import numpy as np

    from flexynesis_torch.utils.clustering import k_means_clustering, silhouette_score

    rng = np.random.default_rng(2)
    X = rng.normal(scale=4, size=(6, 16))[rng.integers(0, 6, 2000)] + rng.normal(size=(2000, 16))
    for k in (2, 6, 9):
        lc, kc = k_means_clustering(X, k, device="cuda")
        lp, kp = k_means_clustering(X, k, device="cpu")
        assert (lc == lp).all()
        assert abs(kc.inertia_ - kp.inertia_) <= 1e-8 * kp.inertia_
        assert abs(silhouette_score(X, lc, device="cuda")
                   - silhouette_score(X, lp, device="cpu")) <= 1e-8


# ---------------------------------------------------------------- the mesh
# (int8 moments, noisy GradientShap, trial rounds over [cuda:0, cuda:0], the
# one-rank NCCL data-parallel fit)


def _mesh_dataset(n=96, gex=80, cnv=40, seed=0):
    import numpy as np

    from flexynesis_torch.data.dataset import MultiOmicDataset

    rng = np.random.default_rng(seed)
    cls = rng.integers(0, 3, n).astype(np.float32)
    return MultiOmicDataset(
        dat={"gex": (rng.normal(size=(n, gex)) + cls[:, None]).astype(np.float32),
             "cnv": rng.normal(size=(n, cnv)).astype(np.float32)},
        ann={"subtype": cls}, variable_types={"subtype": "categorical"},
        features={"gex": [f"g{i}" for i in range(gex)], "cnv": [f"c{i}" for i in range(cnv)]},
        samples=[f"S{i}" for i in range(n)],
        label_mappings={"subtype": {0: "a", 1: "b", 2: "c"}})


MESH_CFG = {"latent_dim": 8, "hidden_dim_factor": 0.5, "lr": 1e-3, "supervisor_hidden_dim": 8,
            "epochs": 3, "batch_size": 16, "fused_kernels": True}


@pytest.mark.cuda
def test_int8_steps_on_the_card_match_the_cpu(card):
    """Three SR-Adam steps with 8-bit moments on the same leaves, gradients
    and seeds: codes equal but for 1% of them (by one), bfloat16
    parameters within one bfloat16 ulp, scales rtol 1e-3."""
    from flexynesis_torch.ops import sr_adam

    g = torch.Generator().manual_seed(0)
    leaves = [(torch.randn(3, 256, 300, generator=g) * 0.1).to(torch.bfloat16),
              torch.randn(3, 300, generator=g)]
    grads = [[torch.randn(3, 256, 300, generator=g) * 1e-3, torch.randn(3, 300, generator=g)
              * 1e-3] for _ in range(3)]
    out = {}
    for device in (card, torch.device("cpu")):
        p = [t.to(device) for t in leaves]
        st = sr_adam.sr_adam_init(p, "int8")
        for s, gr in enumerate(grads):
            p, st = sr_adam.sr_adam_step(p, st, [x.to(device) for x in gr],
                                         torch.tensor([1e-3, 2e-3, 3e-3], device=device),
                                         torch.tensor([5 + s, 2 ** 32 - 1 - s, 77], device=device),
                                         trial_axis=True)
        out[device.type] = (p, st)
    (pc, sc), (pp, sp) = out["cuda"], out["cpu"]
    assert isinstance(sc.m[0], sr_adam.Q8) and isinstance(sc.v[0], sr_adam.Q8)
    for a, b in ((sc.m[0], sp.m[0]), (sc.v[0], sp.v[0])):
        diff = (a.q.cpu().long() - b.q.long()).abs()
        assert int(diff.max()) <= 1 and float((diff > 0).float().mean()) <= 0.01
        torch.testing.assert_close(a.s.cpu(), b.s, rtol=1e-3, atol=0)
    torch.testing.assert_close(pc[0].cpu().float(), pp[0].float(), rtol=2 ** -8, atol=1e-7)
    torch.testing.assert_close(pc[1].cpu(), pp[1], rtol=1e-5, atol=1e-7)


@pytest.mark.cuda
def test_noisy_gradient_shap_on_the_card_matches_the_cpu(card):
    from flexynesis_torch.interpret.attribution import gradient_shap
    from flexynesis_torch.models.direct_pred import DirectPred
    from flexynesis_torch.utils import prng

    ds = _mesh_dataset()
    got = []
    for device in ("cuda", "cpu"):
        m = DirectPred(dict(MESH_CFG, fused_kernels=False), ds, ["subtype"], device=device)
        m.init_params(2)
        attrs = gradient_shap(lambda xs: m._attribution_forward(xs, "subtype"),
                              m.make_eval_x(ds), range(3), 4, False, prng.key(3), stdevs=0.1)
        got.append([{k: v.detach().cpu() for k, v in a.items()} for a in attrs])
    for a, b in zip(*got):
        for k in a:
            torch.testing.assert_close(a[k], b[k], rtol=1e-4, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("model_name", ["DirectPred", "supervised_vae"])
def test_sharded_round_on_one_card_tracks_the_unsharded_round(card, model_name):
    """A fused round of 8 over [cuda:0, cuda:0] against the unsharded round:
    each kernel launched twice as often (once per shard, planned for the
    whole round, so B1/B2/B3 give a trial the same bits); cuBLAS may take
    other kernels for a shard's 4-trial batched products than for the
    round's 8, and Adam turns the last-bit gaps of shift-only biases into
    lr-sized steps, so the best losses are held within rtol 1e-2 (measured
    1.1e-3) and the best epochs must be equal or a near tie (the unsharded
    loss at the sharded best epoch within 1e-2 of its best)."""
    import numpy as np

    from flexynesis_torch.kernels.mmd import gaussian_kernel_mean as b3
    from flexynesis_torch.models import MODEL_REGISTRY
    from flexynesis_torch.parallel.mesh import get_mesh
    from flexynesis_torch.parallel.trials import ParallelTrials

    ds = _mesh_dataset()
    outs, launches, hist = [], [], []
    for mesh in (None, get_mesh((("trial", 2),), devices=["cuda:0", "cuda:0"])):
        m = MODEL_REGISTRY[model_name](MESH_CFG, ds, ["subtype"], device="cuda")
        fused_linear_bn_relu.launches = fused_linear_bn_relu_eval.launches = b3.launches = 0
        hist.append([])
        outs.append(ParallelTrials(m, ds, mesh=mesh).run(
            np.geomspace(1e-4, 1e-2, 8), np.arange(8), train_idx=np.arange(72),
            val_idx=np.arange(72, 96), batch_size=16, max_epochs=4, early_stop_patience=2,
            on_epoch_end=lambda e, tl, vl, h=hist[-1]: h.append(vl)))
        launches.append((fused_linear_bn_relu.launches, fused_linear_bn_relu_eval.launches,
                         b3.launches))
    assert launches[1] == tuple(2 * x for x in launches[0]) and sum(launches[0]) > 0
    np.testing.assert_allclose(outs[1]["best_val_loss"], outs[0]["best_val_loss"], rtol=1e-2)
    best = outs[0]["best_val_loss"]
    for k, (e1, e0) in enumerate(zip(outs[1]["best_epoch"], outs[0]["best_epoch"])):
        assert e1 == e0 or abs(hist[0][e1 - 1][k] - best[k]) <= 1e-2 * abs(best[k])
    assert outs[1]["epochs_run"] == outs[0]["epochs_run"]


@pytest.mark.cuda
def test_one_rank_nccl_fit_equals_the_plain_fit(card):
    import socket

    import numpy as np

    from flexynesis_torch.models.direct_pred import DirectPred
    from flexynesis_torch.parallel import distributed
    from flexynesis_torch.parallel.mesh import get_mesh

    ds = _mesh_dataset()

    def fit(mesh):
        m = DirectPred(MESH_CFG, ds, ["subtype"], device="cuda")
        return m.fit(ds, np.arange(72), np.arange(72, 96), lr=1e-3, batch_size=16,
                     max_epochs=2, seed=1, mesh=mesh)

    plain = fit(None)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    distributed.initialize(f"tcp://127.0.0.1:{port}", 1, 0)
    try:
        grouped = fit(get_mesh((("data", 1),)))
    finally:
        distributed.shutdown()
    assert grouped.history == plain.history
    for n, t in plain.state.items():
        assert torch.equal(grouped.state[n], t), n


# the SR-bf16 Adam kernel (kernels/sr_adam.py): against the plain chain on
# the card, bit for bit once the plain chain's float64 fused multiply-adds
# are rounded once (fma_rn), as the kernel rounds them
SR_CFG = {"latent_dim": 64, "hidden_dim_factor": 0.3, "supervisor_hidden_dim": 16, "lr": 1e-3,
          "epochs": 1, "batch_size": 64, "fused_kernels": False}
SR_MIXED = [
    {"latent_dim": 64, "hidden_dim_factor": 0.3, "supervisor_hidden_dim": 16, "lr": 1e-3},
    {"latent_dim": 128, "hidden_dim_factor": 0.5, "supervisor_hidden_dim": 32, "lr": 3e-3},
    {"latent_dim": 32, "hidden_dim_factor": 0.2, "supervisor_hidden_dim": 8, "lr": 3e-4},
    {"latent_dim": 96, "hidden_dim_factor": 0.4, "supervisor_hidden_dim": 24, "lr": 1e-4},
]


def _synthetic_sr_leaves(device, K=3):
    """Leaves, masks and gradient layouts beside the models' own: a
    transposed bfloat16 weight (ragged tiles) with a transposed gradient, a
    contiguous bfloat16 weight with a transposed gradient, a transposed
    float32 weight under a broadcasting mask, a masked vector over two flat
    blocks, a bfloat16 vector with no gradient, a (K, 1) leaf, and three
    inner axes with a gradient whose strides do not merge."""
    g = torch.Generator(device=device).manual_seed(1)

    def rnd(*shape, dtype=torch.float32):
        return (torch.randn(*shape, generator=g, device=device) * 0.1).to(dtype)

    bf16 = torch.bfloat16
    leaves = [rnd(K, 300, 130, dtype=bf16).mT, rnd(K, 70, 90, dtype=bf16), rnd(K, 40, 70).mT,
              rnd(K, 5000), rnd(K, 7, dtype=bf16), rnd(K, 1), rnd(K, 3, 4, 65, dtype=bf16)]
    masks = [None, None, (torch.rand(K, 1, 40, generator=g, device=device) > 0.3).float(),
             (torch.rand(K, 5000, generator=g, device=device) > 0.5).float(), None, None, None]

    def layouts(x):  # a gradient of each leaf's shape in the layout above
        return [x[0].mT.contiguous().mT, x[1].mT.contiguous().mT, x[2], x[3], None, x[5],
                x[6].transpose(1, 2).contiguous().transpose(1, 2)]
    return leaves, masks, layouts


def _many_sr_leaves(device, K=3):
    """300 leaves, more than a block of the kernel has threads (its leaf
    vote runs in rounds): transposed bfloat16 weights, contiguous float32
    weights and bfloat16 vectors in turn, every seventh without a
    gradient."""
    g = torch.Generator(device=device).manual_seed(2)
    leaves = []
    for i in range(300):
        x = torch.randn(K, 3 + i % 70, 2 + i % 90, generator=g, device=device) * 0.1
        leaves.append((x.bfloat16().mT, x, x[:, 0].bfloat16())[i % 3])

    def layouts(x):
        return [None if i % 7 == 0 else t for i, t in enumerate(x)]
    return leaves, None, layouts


def _nine_layer_dataset(n=64):
    """Nine omics layers of 150-550 features: a supervised_vae of 138
    leaves."""
    import numpy as np

    from flexynesis_torch.data.dataset import MultiOmicDataset

    rng = np.random.default_rng(0)
    cls = rng.integers(0, 3, n).astype(np.float32)
    widths = {f"omic{i}": 150 + 50 * i for i in range(9)}
    return MultiOmicDataset(
        dat={m: rng.normal(size=(n, d)).astype(np.float32) for m, d in widths.items()},
        ann={"subtype": cls}, variable_types={"subtype": "categorical"},
        features={m: [f"{m}_{i}" for i in range(d)] for m, d in widths.items()},
        samples=[f"S{i}" for i in range(n)],
        label_mappings={"subtype": {0: "a", 1: "b", 2: "c"}})


def _sr_leaf_set(name, device):
    """(leaves, masks, gradient layouts, K, shared seed) of a set."""
    import numpy as np

    from flexynesis_torch.models import MODEL_REGISTRY
    from flexynesis_torch.models.direct_pred import DirectPred
    from flexynesis_torch.parallel.hetero import build_padded_trials, max_config
    from flexynesis_torch.parallel.trials import _init_stacked, _Round

    if name == "synthetic":
        leaves, masks, layouts = _synthetic_sr_leaves(device)
        return leaves, masks, layouts, 3, False
    if name == "many":
        leaves, masks, layouts = _many_sr_leaves(device)
        return leaves, masks, layouts, 3, False
    if name == "supervised_vae_9":
        model = MODEL_REGISTRY["supervised_vae"](SR_CFG, _nine_layer_dataset(), ["subtype"],
                                                 device=device)
        params, buffers = _init_stacked(model, [0] * 16)
        rnd = _Round(model, params, buffers, lrs=np.geomspace(1e-4, 1e-2, 16), seeds=[0] * 16)
        assert len(rnd.views) == 138
        return rnd.views, None, list, 16, True
    ds = _mesh_dataset(n=64, gex=2000, cnv=1000)
    if name == "padded":
        group = [dict(SR_CFG, **c) for c in SR_MIXED]
        model = DirectPred(max_config(group, [2000, 1000]), ds, ["subtype"], device=device)
        seeds = np.arange(3, 3 + len(group))
        t = build_padded_trials(model, group, seeds)
        rnd = _Round(model, t["params"], t["buffers"], lrs=[c["lr"] for c in SR_MIXED],
                     seeds=seeds, masks=t["masks"])
        return rnd.views, rnd.masks, list, len(group), False
    model = MODEL_REGISTRY[name](SR_CFG, ds, ["subtype"], device=device)
    params, buffers = _init_stacked(model, [0] * 16)
    rnd = _Round(model, params, buffers, lrs=np.geomspace(1e-4, 1e-2, 16), seeds=[0] * 16)
    return rnd.views, None, list, 16, True


def _sr_grads(leaves, layouts, clipped, gen):
    """Gradients of the leaves' shapes: 1e-5 N(0, 1) (a norm near 0.02: the
    clip scale is exactly 1) or +-2^-4 or 0 (exact squares: every order of
    summation gives the same norm, so the clip scale is the same)."""
    out = []
    for v in leaves:
        x = torch.randn(v.shape, generator=gen, device=v.device)
        out.append(torch.sign(x) * (x.abs() > 0.5) * 2.0 ** -4 if clipped else x * 1e-5)
    return layouts(out)


def _copy_layout(t):
    return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device=t.device).copy_(t)


def _bits_of(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("clipped", [False, True])
@pytest.mark.parametrize("name", ["DirectPred", "supervised_vae", "padded", "synthetic",
                                  "supervised_vae_9", "many"])
def test_sr_adam_kernel_gives_the_plain_chain_bits(card, monkeypatch, name, clipped):
    """Three steps of the kernel against three of ``sr_adam_step`` on the same
    gradients, seeds near 2^32 and per-trial lrs: parameters, m and v bit
    for bit against the chain with single-rounded fused multiply-adds, so
    that every entry where the kernel parts from the plain chain is a
    double rounding of the latter's float64 route; the same bits on a
    repeat; padded entries exactly zero; two launches a step."""
    from flexynesis_torch.kernels import sr_adam as kernel
    from flexynesis_torch.ops import sr_adam

    leaves, masks, layouts, K, shared = _sr_leaf_set(name, card)
    lr = torch.logspace(-4, -2, K, device=card)
    steps = []
    gen = torch.Generator(device=card).manual_seed(11)
    for s in range(3):
        seed = torch.tensor([2 ** 32 - 1 - 97 * s - k for k in range(1 if shared else K)],
                            device=card)
        steps.append((_sr_grads(leaves, layouts, clipped, gen), seed))

    def plain():
        p = [_copy_layout(t) for t in leaves]
        st = sr_adam.sr_adam_init(p)
        for grads, seed in steps:
            grads = [torch.zeros(v.shape, device=card) if x is None else x
                     for v, x in zip(leaves, grads)]
            p, st = sr_adam.sr_adam_step(p, st, grads, lr, seed, masks=masks, trial_axis=True)
        return [*p, *st.m, *st.v]

    def fused():
        p = [_copy_layout(t) for t in leaves]
        st = sr_adam.sr_adam_init(p)
        plan = kernel.FusedSRAdam(p, st, masks)
        for grads, seed in steps:
            before = kernel.FusedSRAdam.launches
            st = plan.step(st, grads, lr, seed)
            assert kernel.FusedSRAdam.launches == before + kernel.LAUNCHES_PER_STEP == before + 2
        assert st.count == 3
        return [*p, *st.m, *st.v]

    want = plain()
    with monkeypatch.context() as mp:
        mp.setattr(sr_adam, "_fma", kernel.fma_rn)
        once = plain()
    got = fused()
    torch.cuda.synchronize()
    n = len(leaves)
    for i, (a, b) in enumerate(zip(got, once)):
        what = ("parameter", "m", "v")[i // n]
        assert torch.equal(_bits_of(a), _bits_of(b)), (what, i % n, tuple(a.shape))
    again = fused()
    assert all(torch.equal(_bits_of(a), _bits_of(b)) for a, b in zip(got, again))
    double = sum(int((_bits_of(a) != _bits_of(b)).sum()) for a, b in zip(once, want))
    assert double <= 1e-4 * sum(t.numel() for t in want)  # double roundings are rare
    if masks is not None and name == "padded":
        for p, k in zip(got[:n], masks):
            assert not bool(((p.float() * (1 - k)) != 0).any())


@pytest.mark.cuda
def test_round_step_takes_the_kernel_in_place(card, monkeypatch):
    """Three SR-bf16 stacked steps of a padded DirectPred round with fixed
    SR seeds: the kernel's in-place path (two launches a step, one plan for
    the round) against the same round on the plain chain and its copy back,
    with single-rounded fused multiply-adds and the norm summed in float64
    as the kernel sums it (the model's gradients clip): parameters, moments
    and losses bit for bit."""
    import numpy as np

    from flexynesis_torch.kernels import sr_adam as kernel
    from flexynesis_torch.models.direct_pred import DirectPred
    from flexynesis_torch.ops import sr_adam
    from flexynesis_torch.parallel import trials
    from flexynesis_torch.parallel.hetero import build_padded_trials, max_config

    ds = _mesh_dataset(n=96, gex=300, cnv=200)
    group = [dict(SR_CFG, **c) for c in SR_MIXED]
    seeds = np.arange(3, 7)

    def run():
        model = DirectPred(max_config(group, [300, 200]), ds, ["subtype"], device="cuda")
        t = build_padded_trials(model, group, seeds)
        rnd = trials._Round(model, t["params"], t["buffers"], lrs=[c["lr"] for c in SR_MIXED],
                            seeds=seeds, masks=t["masks"])
        data = model.make_batch(ds)
        before = kernel.FusedSRAdam.launches
        losses = [rnd.step(trials._gather(data, torch.arange(16 * s, 16 * s + 16, device=card)),
                           torch.tensor([2 ** 32 - 1 - 97 * s - k for k in range(4)],
                                        device=card)) for s in range(3)]
        return rnd, torch.stack(losses), kernel.FusedSRAdam.launches - before

    fused, fused_losses, launches = run()
    assert launches == 3 * kernel.LAUNCHES_PER_STEP and fused.fused is not None
    assert fused.count == 3
    with monkeypatch.context() as mp:
        mp.setattr(trials, "fused_update_applies", lambda params, state: False)
        mp.setattr(sr_adam, "_fma", kernel.fma_rn)
        mp.setattr(sr_adam, "global_norm_f32", kernel.global_norm_f64)
        plain, plain_losses, plain_launches = run()
    assert plain_launches == 0 and plain.fused is None
    assert torch.equal(fused_losses, plain_losses)
    for a, b in zip([*fused.views, *fused.opt_state.m, *fused.opt_state.v],
                    [*plain.views, *plain.opt_state.m, *plain.opt_state.v]):
        assert torch.equal(_bits_of(a), _bits_of(b))
