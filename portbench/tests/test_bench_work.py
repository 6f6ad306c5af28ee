"""``work.py``'s counts at small shapes, each model's products from its
class module, and that no share it computes can pass 100% at a device time
no shorter than the least time."""

from __future__ import annotations

import pytest

from portbench import core, work


def params(model_class, arch, input_dims, n_classes):
    shapes = core.model_module(model_class).matmul_shapes(arch, input_dims, n_classes)
    return work.matmul_params(shapes)


def test_directpred_params():
    arch = {"latent_dim": 4, "hidden_dim_factor": 0.5, "supervisor_hidden_dim": 3}
    # gex 10 -> 5 -> 4, cnv 6 -> 3 -> 4, fusion 8 -> 4, head 4 -> 3 -> 2
    assert params("DirectPred", arch, [10, 6], 2) == (
        10 * 5 + 5 * 4 + 6 * 3 + 3 * 4 + 8 * 4 + 4 * 3 + 3 * 2)


def test_vae_params():
    arch = {"latent_dim": 4, "hidden_dim_factor": 0.5, "supervisor_hidden_dim": 3}
    enc = 10 * 5 + 2 * 5 * 4 + 6 * 3 + 2 * 3 * 4
    dec = 4 * 5 + 5 * 10 + 4 * 3 + 3 * 6
    assert params("supervised_vae", arch, [10, 6], 2) == (
        enc + 2 * 8 * 4 + dec + 4 * 3 + 3 * 2)


def test_step_flops():
    assert work.train_flops(100, 8) == 6 * 100 * 8
    assert work.forward_flops(100, 8) == 2 * 100 * 8
    assert work.ig_flops(100, 8, 4) == 2 * 100 * 8 * 5


def test_kernel_counts():
    flops, nbytes = work.b3_term_work(1, 2, 3, 4, prior_per_trial=True)
    pairs = 3 + 6 + 6
    assert flops == 2 * pairs * 4 + 2 * 5 * 4 + 6 * pairs
    assert nbytes == 4 * (5 * 4 + 4)
    # a shared prior is read and its self-mean counted once
    shared, _ = work.b3_term_work(4, 2, 3, 4, prior_per_trial=False)
    own, _ = work.b3_term_work(4, 2, 3, 4, prior_per_trial=True)
    assert shared < own


@pytest.mark.parametrize("work_of", [
    lambda: work.b3_mean_work(200, 400, 64),
    lambda: work.b3_term_work(16, 200, 64, 64, False),
    lambda: (work.train_flops(1_567_000, 64 * 16), 0.0),
])
@pytest.mark.parametrize("slower", [1.0, 1.0001, 2.0, 1e3])
def test_share_never_above_100(work_of, slower):
    flops, nbytes = work_of()
    least = work.least_seconds(flops, nbytes)
    assert work.share_pct(least, least * slower) <= 100.0
    assert work.mfu_pct(flops, least * slower) <= 100.0 + 1e-9


def test_share_of_nothing_is_none():
    assert work.share_pct(0.0, 1.0) is None
    assert work.share_pct(1e-6, 0.0) is None
    assert work.mfu_pct(0.0, 1.0) is None
