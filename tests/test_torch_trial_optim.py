"""The trial engines' non-stochastic-rounding chain
(``flexynesis_torch/ops/optim.py``: ``scale_by_adam_lowp`` and
``trial_optimizer``, global-norm clip 1.0 per trial then Adam) against
``flexynesis_tpu/ops/optim.py`` under ``vmap`` over a trial axis, on the same
numpy gradients:

* float32 moments: updates and moments within rtol 2e-5. The port's chain
  keeps ``ClippedAdam``'s arithmetic, whose bias corrections ``1 - b**t``
  are computed in double, where optax raises the float32 ``b`` to a float32
  power: at step 1 the second one differs by 1.3e-5 relative, the update by
  6.4e-6, and over four steps up to 1.05e-5 (``tests/test_torch_train.py``
  holds one ClippedAdam step to optax at rtol 1e-5);
* bfloat16 moments: the stored moments within one bfloat16 ulp (2^-8
  relative), the updates within 1e-2 relative;
* float32 moments through ``trial_update_step`` give each trial exactly the
  parameters of ``train/trainer.py::ClippedAdam`` with that trial's lr (bit
  for bit), clipped and unclipped."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexynesis_tpu.ops.optim import scale_by_adam_lowp as jax_scale_by_adam_lowp
from flexynesis_tpu.ops.optim import trial_optimizer as jax_trial_optimizer
from flexynesis_torch.ops.optim import scale_by_adam_lowp, trial_optimizer
from flexynesis_torch.ops.sr_adam import trial_update_step
from flexynesis_torch.train.trainer import ClippedAdam

K = 3
SHAPES = [(8, 4), (4,), (4, 2)]


def _grads(rng, scale):
    return [(rng.normal(size=(K, *s)) * scale).astype(np.float32) for s in SHAPES]


def _as_tree(leaves):
    return {f"w{i}": jnp.asarray(a) for i, a in enumerate(leaves)}


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_scale", [0.05, 3.0])  # unclipped, clipped
def test_trial_optimizer_matches_jax_under_vmap(moment_dtype, grad_scale):
    rng = np.random.default_rng(int(grad_scale * 10))
    params = [np.zeros((K, *s), np.float32) for s in SHAPES]
    j_tx = jax_trial_optimizer(moment_dtype)
    j_state = jax.vmap(j_tx.init)(_as_tree(params))
    j_update = jax.jit(jax.vmap(lambda g, s: j_tx.update(g, s)))
    tx = trial_optimizer(moment_dtype)
    state = tx.init([torch.from_numpy(p) for p in params])
    for _ in range(4):
        g = _grads(rng, grad_scale)
        j_u, j_state = j_update(_as_tree(g), j_state)
        u, state = tx.update([torch.from_numpy(a) for a in g], state)
        adam = j_state[1]  # (clip state, ScaleByAdamState)
        for i in range(len(SHAPES)):
            want_u = np.asarray(j_u[f"w{i}"])
            mu, nu = adam.mu[f"w{i}"], adam.nu[f"w{i}"]
            if moment_dtype == "float32":
                np.testing.assert_allclose(u[i].numpy(), want_u, rtol=2e-5, atol=1e-7)
                for got, want in ((state.mu[i], mu), (state.nu[i], nu)):
                    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                                               atol=1e-12)
            else:
                assert state.mu[i].dtype == torch.bfloat16
                np.testing.assert_allclose(u[i].numpy(), want_u, rtol=1e-2, atol=1e-3)
                for got, want in ((state.mu[i], mu), (state.nu[i], nu)):
                    np.testing.assert_allclose(got.float().numpy(),
                                               np.asarray(want, np.float32),
                                               rtol=2.0 ** -8, atol=1e-30)


def test_scale_by_adam_lowp_float32_matches_jax():
    rng = np.random.default_rng(5)
    params = [np.zeros((K, *s), np.float32) for s in SHAPES]
    j_tx = jax_scale_by_adam_lowp(state_dtype=jnp.float32)
    j_state = jax.vmap(j_tx.init)(_as_tree(params))
    tx = scale_by_adam_lowp(state_dtype=torch.float32)
    state = tx.init([torch.from_numpy(p) for p in params])
    for _ in range(3):
        g = _grads(rng, 0.5)
        j_u, j_state = jax.vmap(lambda g, s: j_tx.update(g, s))(_as_tree(g), j_state)
        u, state = tx.update([torch.from_numpy(a) for a in g], state)
        for i in range(len(SHAPES)):
            np.testing.assert_allclose(u[i].numpy(), np.asarray(j_u[f"w{i}"]), rtol=2e-5,
                                       atol=1e-7)
    assert state.count == 3


@pytest.mark.parametrize("grad_scale", [0.05, 3.0])
def test_float32_trial_steps_equal_clipped_adam(grad_scale):
    rng = np.random.default_rng(11)
    lrs = np.array([1e-3, 3e-3, 2e-2], np.float32)
    start = [rng.normal(size=(K, *s)).astype(np.float32) for s in SHAPES]
    tx = trial_optimizer("float32")
    stacked = [torch.from_numpy(a.copy()) for a in start]
    state = tx.init(stacked)
    singles = [[torch.from_numpy(a[k].copy()) for a in start] for k in range(K)]
    adams = [ClippedAdam(singles[k], lr=float(lrs[k])) for k in range(K)]
    for _ in range(4):
        g = _grads(rng, grad_scale)
        stacked, state = trial_update_step(stacked, state, [torch.from_numpy(a) for a in g],
                                           torch.from_numpy(lrs), None, sr=False, tx=tx)
        for k in range(K):
            adams[k].step([torch.from_numpy(a[k].copy()) for a in g])
    for k in range(K):
        for got, want in zip(stacked, singles[k]):
            assert torch.equal(got[k], want)
        for got, want in zip(state.mu, adams[k].mu):
            assert torch.equal(got[k], want)


def test_masked_step_keeps_padded_entries_at_zero():
    rng = np.random.default_rng(2)
    p = [torch.from_numpy(rng.normal(size=(K, 4, 6)).astype(np.float32))]
    mask = torch.ones(K, 4, 6)
    mask[:, :, 4:] = 0
    p[0] = p[0] * mask
    tx = trial_optimizer("bfloat16")
    state = tx.init(p)
    for _ in range(3):
        g = [torch.from_numpy(rng.normal(size=(K, 4, 6)).astype(np.float32))]
        p, state = trial_update_step(p, state, g, torch.tensor([1e-2, 1e-3, 5e-2]), None,
                                     sr=False, tx=tx, masks=[mask])
    assert torch.equal(p[0][:, :, 4:], torch.zeros(K, 4, 2))
