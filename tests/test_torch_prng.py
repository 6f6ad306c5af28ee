"""The port's numpy copy of ``jax.random``'s threefry2x32 generator
(``flexynesis_torch/utils/prng.py``) against ``jax.random`` itself, bit for
bit: keys from seeds, ``split`` and float32 ``uniform`` at the shapes
GradientShap draws, (1, 1), (500, 1) and (512, 1), and GradientShap's key
schedule over two batches; ``fold_in`` bit for bit; the hash on tensors
(``torch_bits``, int64 masked to 32 bits) bit for bit against the numpy hash,
a row offset drawing the rows of a larger draw; ``normal`` against
``jax.random.normal``: its uniforms bit for bit (checked through the bits),
its values within 4 float32 ulp (the copy of XLA's ErfInv parts from it
where ``log1p`` differs in the last place; measured at most 3 ulp, on under
5% of the values)."""

import jax
import numpy as np
import pytest
import torch

from flexynesis_torch.utils import prng

SEEDS = [0, 1, 42, 2024, 2 ** 31 - 1]


def _key_data(k):
    return np.asarray(jax.random.key_data(k))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_split_match_jax(seed):
    k = jax.random.key(seed)
    assert np.array_equal(prng.key(seed), _key_data(k))
    for num in (2, 3, 25):
        ours = prng.split(prng.key(seed), num)
        assert ours.dtype == np.uint32
        assert np.array_equal(ours, _key_data(jax.random.split(k, num)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(1, 1), (500, 1), (512, 1)])
def test_uniform_matches_jax_bit_for_bit(seed, shape):
    k = jax.random.split(jax.random.key(seed))[1]
    ours = prng.uniform(prng.split(prng.key(seed))[1], shape)
    theirs = np.asarray(jax.random.uniform(k, shape))
    assert ours.dtype == theirs.dtype == np.float32 and ours.shape == shape
    assert np.array_equal(ours.view(np.uint32), theirs.view(np.uint32))
    assert (ours >= 0).all() and (ours < 1).all()


def test_gradient_shap_key_schedule_matches_jax():
    """key(42); per batch rng, sub = split(rng); split(sub, n_samples); per
    key ku, kn = split(key); uniform(ku, (n_batch, 1))."""
    rng, ours_rng = jax.random.key(42), prng.key(42)
    for n_batch in (512, 37):
        rng, sub = jax.random.split(rng)
        ours_rng, ours_sub = prng.split(ours_rng)
        for key, ours_key in zip(jax.random.split(sub, 4), prng.split(ours_sub, 4)):
            ku, _ = jax.random.split(key)
            theirs = np.asarray(jax.random.uniform(ku, (n_batch, 1)))
            ours = prng.uniform(prng.split(ours_key)[0], (n_batch, 1))
            assert np.array_equal(ours.view(np.uint32), theirs.view(np.uint32))


def test_seed_out_of_range_raises():
    with pytest.raises(ValueError):
        prng.key(-1)
    with pytest.raises(ValueError):
        prng.key(2 ** 31)


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_matches_jax(seed):
    for data in (0, 1, 2, 7, 2 ** 32 - 1):
        theirs = _key_data(jax.random.fold_in(jax.random.key(seed), data))
        assert np.array_equal(prng.fold_in(prng.key(seed), data), theirs)


@pytest.mark.parametrize("shape", [(7,), (40, 24), (3, 5, 2)])
@pytest.mark.parametrize("offset", [0, 2])
def test_torch_bits_match_the_numpy_hash(shape, offset):
    k = prng.fold_in(prng.key(9), 1)
    b1, b2 = prng._hash_iota(k, shape)
    whole = prng.torch_bits(k, shape, "cpu")
    assert whole.dtype == torch.int64
    assert np.array_equal(whole.numpy(), (b1 ^ b2).astype(np.int64))
    part = prng.torch_bits(k, (shape[0] - offset,) + shape[1:], "cpu", row_offset=offset)
    assert torch.equal(part, whole[offset:])


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(40, 24), (200, 300)])
def test_normal_matches_jax(seed, shape):
    k = prng.fold_in(prng.key(seed), 3)
    theirs = np.asarray(jax.random.normal(jax.random.wrap_key_data(k), shape))
    ours = prng.normal(k, shape, "cpu").numpy()
    assert ours.dtype == np.float32 and ours.shape == shape
    ulps = np.abs(ours.view(np.int32).astype(np.int64) - theirs.view(np.int32).astype(np.int64))
    assert ulps.max() <= 4
    assert np.array_equal(prng.normal(k, (shape[0] - 5,) + shape[1:], "cpu",
                                      row_offset=5).numpy(), ours[5:])
