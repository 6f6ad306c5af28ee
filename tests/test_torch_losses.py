"""The port's supervised losses (flexynesis_torch.ops.losses) against the JAX
package's (flexynesis_tpu.ops.losses): values and gradients on the same
numpy inputs, including the degenerate Cox batches (all invalid, a single
event, all censored, non-finite outputs) whose gradients must stay finite.

Tolerance: rtol=1e-5, atol=1e-6 (f32, the same formulas)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexynesis_tpu.ops import losses as jl
from flexynesis_torch.ops import losses as tl

TOL = dict(rtol=1e-5, atol=1e-6)


def value_and_grad_both(jfn, tfn, x, *rest):
    jv, jg = jax.value_and_grad(lambda a: jfn(a, *map(jnp.asarray, rest)))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    tv = tfn(xt, *map(torch.from_numpy, rest))
    (tg,) = torch.autograd.grad(tv, xt)
    return (float(jv), np.asarray(jg)), (float(tv.detach()), tg.numpy())


def check(jfn, tfn, x, *rest):
    (jv, jg), (tv, tg) = value_and_grad_both(jfn, tfn, x, *rest)
    np.testing.assert_allclose(tv, jv, **TOL)
    np.testing.assert_allclose(tg, jg, **TOL)
    assert np.isfinite(tg).all()


@pytest.mark.parametrize("case", ["mixed", "all_nan"])
def test_masked_mse(case):
    rng = np.random.default_rng(0)
    y_hat = rng.normal(size=(12, 1)).astype(np.float32)
    y = rng.normal(size=12).astype(np.float32)
    y[[1, 5]] = np.nan
    if case == "all_nan":
        y[:] = np.nan
    check(jl.masked_mse_loss, tl.masked_mse_loss, y_hat, y)


@pytest.mark.parametrize("case", ["mixed", "all_missing"])
def test_masked_ce(case):
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(10, 4)).astype(np.float32)
    y = rng.integers(0, 4, 10).astype(np.float32)
    y[2], y[7] = -1, np.nan
    if case == "all_missing":
        y[:] = -1
    check(jl.masked_ce_loss, tl.masked_ce_loss, logits, y)


def cox_case(name):
    rng = np.random.default_rng(2)
    n = 16
    out = rng.normal(size=n).astype(np.float32)
    dur = rng.exponential(10, n).astype(np.float32)
    dur[3] = dur[4]  # a tie
    ev = (rng.random(n) < 0.6).astype(np.float32)
    if name == "mixed":
        dur[[0, 9]] = np.nan
        ev[5] = np.nan
    elif name == "all_invalid":
        dur[:] = np.nan
    elif name == "single_event":
        ev[:] = 0
        ev[6] = 1
    elif name == "all_censored":
        ev[:] = 0
    elif name == "nonfinite_outputs":
        out[[1, 2]] = [np.inf, np.nan]
    return out, dur, ev


@pytest.mark.parametrize("name", ["mixed", "all_invalid", "single_event",
                                  "all_censored", "nonfinite_outputs"])
def test_cox_ph(name):
    check(jl.cox_ph_loss, tl.cox_ph_loss, *cox_case(name))


@pytest.mark.parametrize("weighting", [True, False])
def test_compute_total_loss(weighting):
    rng = np.random.default_rng(3)
    losses = {k: rng.random(dtype=np.float32) for k in ("a", "b")}
    log_vars = {k: rng.normal(size=1).astype(np.float32) for k in ("a", "b")}
    want = jl.compute_total_loss(
        {k: jnp.asarray(v) for k, v in losses.items()},
        {k: jnp.asarray(v) for k, v in log_vars.items()}, weighting)
    got = tl.compute_total_loss(
        {k: torch.tensor(v) for k, v in losses.items()},
        {k: torch.from_numpy(v) for k, v in log_vars.items()}, weighting)
    np.testing.assert_allclose(float(got), float(want), **TOL)
    # one loss: never weighted
    one = tl.compute_total_loss({"a": torch.tensor(losses["a"])},
                                {"a": torch.from_numpy(log_vars["a"])}, weighting)
    np.testing.assert_allclose(float(one), losses["a"], **TOL)
