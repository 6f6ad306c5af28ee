"""The port's MLP and FusedMLP blocks in eval mode against the JAX modules,
with the weights carried across by flexynesis_torch.convert (training mode:
tests/test_torch_train.py).

Tolerance: rtol=1e-4, atol=1e-5 (f32, as tests/test_torch_parity.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from flexynesis_tpu.ops.fused_mlp import FusedMLP as JaxFusedMLP
from flexynesis_tpu.ops.mlp import MLP as JaxMLP
from flexynesis_torch.convert import from_flax, to_flax
from flexynesis_torch.ops.fused_mlp import FusedMLP
from flexynesis_torch.ops.mlp import MLP


def _random_stats(rng, stats):
    """Non-trivial running statistics in the tree layout of ``stats``."""
    return jax.tree.map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if a.shape and np.all(np.asarray(a) == 1)
        else rng.normal(0, 0.3, a.shape).astype(np.float32),
        stats,
    )


def _trees_equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_trees_equal(a[k], b[k]) for k in a)
    return np.array_equal(np.asarray(a), np.asarray(b)) and np.asarray(a).dtype == np.asarray(b).dtype


def _holder(block):
    m = nn.Module()
    m.add_module("blk", block)
    return m


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("B,F,hidden,out", [(16, 40, 12, 5), (9, 30, 1, 1)])
def test_block_matches_jax(fused, B, F, hidden, out):
    rng = np.random.default_rng(B + F + hidden + out)
    x = rng.normal(size=(B, F)).astype(np.float32)
    jax_block = (JaxFusedMLP if fused else JaxMLP)(hidden_dim=hidden, output_dim=out)
    variables = jax_block.init(jax.random.key(B), jnp.asarray(x), train=False)
    params = variables["params"]
    stats = _random_stats(rng, variables["batch_stats"])
    ref = jax_block.apply({"params": params, "batch_stats": stats},
                          jnp.asarray(x), train=False)

    holder = _holder((FusedMLP if fused else MLP)(F, hidden, out))
    holder.load_state_dict(from_flax({"blk": params}, {"blk": stats}))
    holder.eval()
    with torch.no_grad():
        y = holder.blk(torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)

    # hidden width clamped to >= 2; no output bias for a single output
    assert holder.blk.layer_out.in_features == max(hidden, 2)
    assert (holder.blk.layer_out.bias is None) == (out == 1)

    # the round trip through the port is exact
    p_back, s_back = to_flax(holder)
    assert _trees_equal(p_back, {"blk": jax.tree.map(np.asarray, params)})
    assert _trees_equal(s_back, {"blk": stats})


def test_fused_block_raises_in_training_mode():
    """Training mode runs kernel B1 and needs a generator for its dropout."""
    block = FusedMLP(6, 4, 2).train()
    with pytest.raises(ValueError, match="Generator"):
        block(torch.zeros(3, 6))


def test_training_dropout_needs_a_generator():
    block = MLP(6, 4, 2)
    block.reset_parameters(torch.Generator().manual_seed(0))
    block.train()
    with pytest.raises(ValueError, match="Generator"):
        block(torch.zeros(3, 6))
    y1 = block(torch.ones(3, 6), torch.Generator().manual_seed(1))
    y2 = block(torch.ones(3, 6), torch.Generator().manual_seed(1))
    torch.testing.assert_close(y1, y2)
