"""The port's numpy copy of ``jax.random``'s threefry2x32 generator
(``flexynesis_torch/utils/prng.py``) against ``jax.random`` itself, bit for
bit: keys from seeds, ``split`` and float32 ``uniform`` at the shapes
GradientShap draws, (1, 1), (500, 1) and (512, 1), and GradientShap's key
schedule over two batches."""

import jax
import numpy as np
import pytest

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
