"""The port's stochastic-rounding Adam (``flexynesis_torch/ops/sr_adam.py``)
against ``flexynesis_tpu/ops/sr_adam.py`` on the same numpy inputs:

* ``hash_bits`` and ``sr_bf16`` bit for bit, at several shapes and seeds
  (seeds near 2^32 wrap around), and with a trial axis against ``vmap`` of
  the JAX functions (the hash runs over each trial's own flat index);
* ``sr_adam_step`` on a small mixed bfloat16/float32 tree, with and without
  element masks, clipped and unclipped, unstacked and with a trial axis
  (``vmap`` of the JAX step, per-trial lr and seed): parameters and moments
  bit for bit over three steps;
* ``cast_stacked_params_for_sr``: the size threshold applies per trial;
* ``sr_adam_init``: zero moments of each leaf's type, as the JAX "mirror"
  moments.

No tolerance: the port reproduces XLA's float arithmetic for this step. The
one exception is a clipped step with a trial axis: XLA sums each trial's
squares in an order the port does not reproduce, so the clip scale may differ
in its last bit; there the values are held within one bfloat16 ulp (2^-8
relative) and float32 leaves within 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexynesis_tpu.ops import sr_adam as jax_sr
from flexynesis_torch.ops import sr_adam

SEEDS = [0, 1, 12345, 2**31 + 7, 2**32 - 1]


def _bits(a) -> np.ndarray:
    """The raw bits of a float array (bfloat16 as uint16)."""
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return a.view(np.uint16)
    return a.view(np.uint32)


def _torch_bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("shape", [(7,), (3, 5), (2, 3, 4), (300, 257)])
@pytest.mark.parametrize("seed", SEEDS)
def test_hash_bits_match_jax(shape, seed):
    want = np.asarray(jax_sr.hash_bits(shape, jnp.uint32(seed)))
    got = sr_adam.hash_bits(shape, seed).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("shape", [(9,), (33, 17), (4, 5, 6)])
@pytest.mark.parametrize("seed", SEEDS)
def test_sr_bf16_matches_jax(shape, seed):
    rng = np.random.default_rng(seed % 1000 + len(shape))
    x = (rng.normal(size=shape) * 10.0 ** rng.integers(-6, 3, size=shape)).astype(np.float32)
    x.flat[0] = 0.0
    x.flat[-1] = -x.flat[-1]
    want = jax_sr.sr_bf16(jnp.asarray(x), jnp.uint32(seed))
    got = sr_adam.sr_bf16(torch.from_numpy(x), seed)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_torch_bits(got), _bits(want))


def test_trial_axis_hashes_each_trials_own_index():
    K, shape = 3, (6, 5)
    seeds = np.array([5, 2**32 - 2, 77], np.uint32)
    want = jax.vmap(lambda s: jax_sr.hash_bits(shape, s))(jnp.asarray(seeds))
    got = sr_adam.hash_bits((K, *shape), torch.tensor(seeds.astype(np.int64)), trial_axis=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))
    x = np.random.default_rng(0).normal(size=(K, *shape)).astype(np.float32)
    want = jax.vmap(jax_sr.sr_bf16)(jnp.asarray(x), jnp.asarray(seeds))
    got = sr_adam.sr_bf16(torch.from_numpy(x), torch.tensor(seeds.astype(np.int64)),
                          trial_axis=True)
    np.testing.assert_array_equal(_torch_bits(got), _bits(want))


def _tree(rng, lead=()):
    """A small mixed tree in JAX's flatten order: a bfloat16 Dense kernel
    (SR-stored), its float32 bias and a float32 scalar-like leaf."""
    return {
        "dense": {
            "bias": rng.normal(size=(*lead, 8)).astype(np.float32),
            "kernel": (rng.normal(size=(*lead, 16, 8)) * 0.3).astype(np.float32),
        },
        "log_var": rng.normal(size=(*lead, 1)).astype(np.float32),
    }


def _masks(rng, lead=()):
    col = (np.arange(8) < 5).astype(np.float32)
    return {
        "dense": {"bias": np.broadcast_to(col, (*lead, 8)).copy(),
                  "kernel": np.broadcast_to(col, (*lead, 16, 8)).copy()},
        "log_var": np.ones((*lead, 1), np.float32),
    }


def _jax_params(tree):
    out = jax.tree.map(jnp.asarray, tree)
    out["dense"]["kernel"] = out["dense"]["kernel"].astype(jnp.bfloat16)
    return out


def _port_leaves(tree):
    leaves = [torch.from_numpy(np.array(a)) for a in jax.tree.leaves(tree)]
    leaves[1] = leaves[1].to(torch.bfloat16)  # dense.kernel
    return leaves


def _assert_tree_bits(port_leaves, jax_tree):
    for got, want in zip(port_leaves, jax.tree.leaves(jax_tree)):
        np.testing.assert_array_equal(_torch_bits(got), _bits(want))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("grad_scale", [0.01, 5.0])  # unclipped, clipped
def test_sr_adam_step_matches_jax(masked, grad_scale):
    rng = np.random.default_rng(int(masked) * 10 + int(grad_scale))
    tree = _tree(rng)
    masks = _masks(rng) if masked else None
    j_params = _jax_params(tree)
    j_state = jax_sr.sr_adam_init(j_params)
    p_params = _port_leaves(tree)
    p_state = sr_adam.sr_adam_init(p_params)
    p_masks = [torch.from_numpy(m) for m in jax.tree.leaves(masks)] if masked else None
    lr, seed = 3e-3, 2**32 - 5
    step_fn = jax.jit(
        lambda p, s, g, sd: jax_sr.sr_adam_step(p, s, g, jnp.float32(lr), sd, masks=masks))
    for step in range(3):
        grads = jax.tree.map(
            lambda a: (rng.normal(size=a.shape) * grad_scale).astype(np.float32), tree)
        j_grads = jax.tree.map(jnp.asarray, grads)
        j_grads["dense"]["kernel"] = j_grads["dense"]["kernel"].astype(jnp.bfloat16)
        j_params, j_state = step_fn(j_params, j_state, j_grads, jnp.uint32(seed + step))
        p_grads = _port_leaves(grads)
        p_params, p_state = sr_adam.sr_adam_step(
            p_params, p_state, p_grads, lr, seed + step, masks=p_masks)
        _assert_tree_bits(p_params, j_params)
        _assert_tree_bits(p_state.m, j_state[0])
        _assert_tree_bits(p_state.v, j_state[1])
        assert p_state.count == int(j_state[2])
    if masked:  # padded entries stay exactly zero when they start there
        assert torch.all(p_params[1].float()[:, 5:] * 0 == 0)


def _assert_tree_close(port_leaves, jax_tree):
    for got, want in zip(port_leaves, jax.tree.leaves(jax_tree)):
        want = np.asarray(want, np.float32)
        rtol = 2.0 ** -8 if got.dtype == torch.bfloat16 else 1e-5
        np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol, atol=1e-12)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("grad_scale", [0.01, 2.0])  # unclipped (exact), clipped
def test_sr_adam_step_with_trial_axis_matches_vmap(masked, grad_scale):
    K = 3
    rng = np.random.default_rng(7 + masked)
    check = _assert_tree_bits if grad_scale < 0.1 else _assert_tree_close
    tree = _tree(rng, (K,))
    if masked:  # padded entries start at zero, as build_padded_trials leaves them
        masks = _masks(rng, (K,))
        tree = jax.tree.map(lambda a, m: a * m, tree, masks)
    else:
        masks = None
    lrs = np.array([1e-3, 3e-3, 1e-2], np.float32)
    j_params = _jax_params(tree)
    j_state = jax.vmap(jax_sr.sr_adam_init)(j_params)
    p_params = _port_leaves(tree)
    p_state = sr_adam.sr_adam_init(p_params)
    p_masks = [torch.from_numpy(m) for m in jax.tree.leaves(masks)] if masked else None

    def one(p, s, g, lr, sd, m):
        return jax_sr.sr_adam_step(p, s, g, lr, sd, masks=m)

    step_fn = jax.jit(jax.vmap(one, in_axes=(0, 0, 0, 0, 0, 0 if masked else None)))
    for step in range(3):
        grads = jax.tree.map(
            lambda a: (rng.normal(size=a.shape) * grad_scale).astype(np.float32), tree)
        seeds = np.array([11 + step, 2**32 - 1 - step, 400 + step], np.uint32)
        j_grads = jax.tree.map(jnp.asarray, grads)
        j_grads["dense"]["kernel"] = j_grads["dense"]["kernel"].astype(jnp.bfloat16)
        j_params, j_state = step_fn(j_params, j_state, j_grads, jnp.asarray(lrs),
                                    jnp.asarray(seeds), masks)
        p_params, p_state = sr_adam.sr_adam_step(
            p_params, p_state, _port_leaves(grads), torch.from_numpy(lrs),
            torch.from_numpy(seeds.astype(np.int64)), masks=p_masks, trial_axis=True)
        check(p_params, j_params)
        check(p_state.m, j_state[0])
        check(p_state.v, j_state[1])
    if masked:
        kernel = p_params[1].float()
        assert torch.equal(kernel[..., 5:], torch.zeros_like(kernel[..., 5:]))


@pytest.mark.parametrize("K", [1, 4])
def test_cast_stacked_threshold_is_per_trial(K):
    n = sr_adam.SR_MIN_SIZE
    leaves = [torch.zeros(K, n), torch.zeros(K, n - 1), torch.zeros(K, 3)]
    got = [a.dtype for a in sr_adam.cast_stacked_params_for_sr(leaves, K)]
    assert got == [torch.bfloat16, torch.float32, torch.float32]
    tree = {"a": jnp.zeros((K, n)), "b": jnp.zeros((K, n - 1)), "c": jnp.zeros((K, 3))}
    want = [a.dtype for a in jax.tree.leaves(jax_sr.cast_stacked_params_for_sr(tree, K))]
    assert [str(d).split(".")[-1] for d in got] == [str(d) for d in want]
    # the unstacked cast counts the whole leaf
    assert sr_adam.cast_params_for_sr([torch.zeros(n)])[0].dtype == torch.bfloat16
    assert sr_adam.cast_params_for_sr([torch.zeros(n - 1)])[0].dtype == torch.float32


def test_init_moments_mirror_each_leaf():
    tree = _tree(np.random.default_rng(3), (2,))
    p_state = sr_adam.sr_adam_init(_port_leaves(tree))
    m, v, count = jax.vmap(jax_sr.sr_adam_init)(_jax_params(tree))
    assert p_state.count == 0 and int(np.max(count)) == 0
    for got, want in zip([*p_state.m, *p_state.v], [*jax.tree.leaves(m), *jax.tree.leaves(v)]):
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
        assert tuple(got.shape) == want.shape and not torch.any(got.float() != 0)
