"""How the SR-bf16 Adam kernel (``kernels/sr_adam.py``, ``csrc/sr_adam.cu``)
is fed a stacked round's leaves, in pure Python that runs without a card:
the leaf table's tiles follow each other leaf after leaf, whatever the leaf
count; the strides of a transposed leaf, and the gradient table's rows, map
the Flax-layout flat index, which the hash runs over, to the right storage
offset; the 32-bit limits hold per trial, not per round; the launch
parameters stay small at any leaf count; 8-bit moments and CPU leaves take
the plain chain; and the plain versions of the kernel's arithmetic that the
card tests hold it to (``fma_rn``: rounded once where the float64 route
rounds twice; ``global_norm_f64``: the float32 norm on exact squares). That
the kernel's blocks update every element of every leaf once is shown on the
card, bit for bit, in ``tests/test_torch_cuda.py`` and ``chip_smoke.py``."""

import numpy as np
import pytest
import torch

from flexynesis_torch.data.dataset import MultiOmicDataset
from flexynesis_torch.kernels import sr_adam as kernel
from flexynesis_torch.models import MODEL_REGISTRY
from flexynesis_torch.ops import sr_adam
from flexynesis_torch.parallel.trials import _gather, _init_stacked, _Round

CFG = {"latent_dim": 8, "hidden_dim_factor": 0.5, "lr": 1e-3, "supervisor_hidden_dim": 6,
       "epochs": 1, "batch_size": 8}


def _dataset(dims=(("gex", 150), ("cnv", 70)), n=24, seed=0):
    rng = np.random.default_rng(seed)
    return MultiOmicDataset(
        dat={m: rng.normal(size=(n, d)).astype(np.float32) for m, d in dims},
        ann={"subtype": rng.integers(0, 3, n).astype(np.float32)},
        variable_types={"subtype": "categorical"},
        features={m: [f"{m}{i}" for i in range(d)] for m, d in dims},
        samples=[f"S{i}" for i in range(n)],
        label_mappings={"subtype": {i: f"g{i}" for i in range(3)}})


def _round(model_name, K=3, dims=(("gex", 150), ("cnv", 70)), moment_dtype="float32"):
    ds = _dataset(dims)
    model = MODEL_REGISTRY[model_name](CFG, ds, target_variables=["subtype"], device="cpu")
    params, buffers = _init_stacked(model, [0] * K)
    return _Round(model, params, buffers, lrs=[1e-3] * K, seeds=[0] * K,
                  moment_dtype=moment_dtype), model, ds


def _synthetic_leaves(K=3):
    """Views as the optimizer sees them: transposed weights (ragged against
    the 64 x 64 tiles, and over two flat blocks), a contiguous weight, a
    vector, a (K,) and a (K, 1) scalar, three inner axes and an empty leaf."""
    g = torch.Generator().manual_seed(0)
    torch_layout = [torch.randn(K, 67, 130, generator=g), torch.randn(K, 5, 1000, generator=g)]
    return ([t.mT for t in torch_layout]
            + [torch.randn(K, 70, 90, generator=g), torch.randn(K, 5000, generator=g),
               torch.randn(K, generator=g), torch.randn(K, 1, generator=g),
               torch.randn(K, 3, 4, 65, generator=g), torch.randn(K, 0, generator=g)])


NINE_LAYERS = tuple((f"omic{i}", 20 + 3 * i) for i in range(9))


def _leaf_sets():
    sets = {"synthetic": _synthetic_leaves()}
    for name in ("DirectPred", "supervised_vae"):
        sets[name] = _round(name)[0].views
    # a supervised_vae of nine omics layers: 138 leaves
    sets["supervised_vae_9"] = _round("supervised_vae", dims=NINE_LAYERS)[0].views
    return sets


LEAF_SETS = ["synthetic", "DirectPred", "supervised_vae", "supervised_vae_9"]


def _table(views):
    """The table of the leaves that hold an element, as ``FusedSRAdam``
    builds it, and their indices."""
    keep = [i for i, v in enumerate(views) if v[0].numel()]
    shapes = [tuple(views[i].shape) for i in keep]
    strides = [kernel.rc_strides(views[i], *kernel.geometry(views[i].shape)) for i in keep]
    return kernel.leaf_table(shapes, strides), views[0].shape[0], keep


@pytest.mark.parametrize("name", LEAF_SETS)
def test_gradient_table_maps_flax_indices_to_storage(name):
    """Each leaf's gradient as the round hands it over (a transposed leaf's
    as a ``.mT`` view), a missing one, and one whose strides do not merge:
    the table's pointer and strides reach every (k, r, c) of the Flax
    layout, and a missing gradient is a null pointer."""
    views = [v for v in _leaf_sets()[name] if v[0].numel()]
    grads = [torch.randn(v.shape).mT.contiguous().mT if v.dim() == 3 else torch.randn(v.shape)
             for v in views]
    grads[0] = None
    unmerged = [i for i, v in enumerate(views) if v.dim() >= 4]
    for i in unmerged:
        grads[i] = torch.randn(views[i].shape).transpose(1, 2).contiguous().transpose(1, 2)
    geom = [kernel.geometry(v.shape) for v in views]
    out = np.zeros((len(views), kernel.GRAD_FIELDS), np.int64)
    copies = kernel.grad_table(grads, geom, out)
    assert len(copies) == len(unmerged)
    assert (out[0] == 0).all()
    for g, row, (R, C) in zip(grads[1:], out[1:], geom[1:]):
        src = next(t for t in [g, *copies] if t.data_ptr() == row[0])
        base = torch.empty(0).set_(src.untyped_storage())
        seen = torch.as_strided(base, (g.shape[0], R, C), tuple(int(x) for x in row[1:]),
                                (int(row[0]) - base.data_ptr()) // 4)
        assert torch.equal(seen, g.reshape(g.shape[0], R, C))


def test_leaf_table_holds_any_leaf_count():
    # more leaves than a block has threads: the kernel's vote runs in rounds
    leaves = [torch.zeros(2, 1 + i % 7, 5 + i % 130).mT if i % 3 else torch.zeros(2, 3 + i)
              for i in range(600)]
    table, K, keep = _table(leaves)
    assert len(keep) == 600 > 256
    starts, tiles = table[:, kernel.F_TILE_START], table[:, kernel.F_TILES]
    assert starts[0] == 0 and (tiles >= 1).all()
    assert (starts[1:] == np.cumsum(tiles)[:-1]).all()
    assert kernel.tiles_per_trial(table) == int(tiles.sum())


@pytest.mark.parametrize("R, C, strides, fits", [
    (1, 2 ** 31 - kernel.FLAT, (0, 0, 1), True),      # a flat vector to the last block
    (1, 2 ** 31 - kernel.FLAT + 1, (0, 0, 1), False),
    (46000, 46000, (0, 1, 46000), True),             # tiled: the tiles' overhang counts
    (46300, 46300, (0, 1, 46300), False),
])
def test_index_limits_hold_per_trial(R, C, strides, fits):
    # the trial axis is 64-bit: a round of many trials of a leaf is no limit
    trial = (2 ** 40, *strides[1:])
    if fits:
        kernel.check_leaf(0, R, C, trial)
    else:
        with pytest.raises(ValueError, match="beyond int32"):
            kernel.check_leaf(0, R, C, trial)


def test_transposed_weights_take_tiles_and_vectors_take_flat_blocks():
    views = _synthetic_leaves()
    table, _, keep = _table(views)
    assert keep == list(range(len(views) - 1))  # the empty leaf gets no row
    modes = table[:, kernel.F_TILES_C] > 0
    assert modes.tolist() == [True, True, False, False, False, False, False]
    assert table[0, kernel.F_TILES] == 2 * 3  # 130 rows x 67 columns of 64 x 64 tiles
    assert table[3, kernel.F_TILES] == 2  # 5000 elements over blocks of 4096
    assert (np.diff(table[:, kernel.F_TILE_START]) == table[:-1, kernel.F_TILES]).all()


@pytest.mark.parametrize("shape", [(3, 40, 70), (2, 1, 65), (4, 130, 3)])
def test_flax_flat_index_of_a_transposed_leaf_maps_to_its_storage_offset(shape):
    K = shape[0]
    storage = torch.arange(int(np.prod(shape))).reshape(shape)  # value = storage offset
    view = storage.mT  # the Flax layout of a torch-layout weight
    R, C = kernel.geometry(view.shape)
    sk, sr, sc = kernel.rc_strides(view, R, C)
    flax_flat = view.contiguous().reshape(K, -1)  # the flat index the hash runs over
    for k in range(K):
        for f in range(R * C):
            r, c = divmod(f, C)
            assert k * sk + r * sr + c * sc == int(flax_flat[k, f]) == int(view[k, r, c])


def test_three_inner_axes_merge_and_unmergeable_strides_are_refused():
    t = torch.randn(2, 3, 4, 5)
    assert kernel.rc_strides(t, 12, 5) == (60, 5, 1)
    assert kernel.rc_strides(t.transpose(1, 2), 12, 5) is None


def test_launch_parameters_fit_the_limit_at_the_vae_leaf_count():
    # a supervised_vae round over nine omics layers, more leaves than any
    # cell's round: its tables are on the device, one row a leaf, and both
    # launches take only the step's struct by value, far within CUDA's
    # 4,096 bytes of kernel parameters: seven pointers, two int64, five
    # int32 and eight floats, padded to 8 bytes
    views = _leaf_sets()["supervised_vae_9"]
    table, _, keep = _table(views)
    assert len(keep) == len(views) == 138
    assert table.shape == (138, kernel.LEAF_FIELDS)
    assert kernel.ctypes.sizeof(kernel._StepArgs) == 128 <= 4096


class _CudaStandIn:
    is_cuda = True


def test_q8_moments_and_cpu_leaves_take_the_plain_chain():
    leaves = [torch.zeros(2, 256, 256, dtype=torch.bfloat16), torch.zeros(2, 4)]
    mirror = sr_adam.sr_adam_init(leaves)
    q8 = sr_adam.sr_adam_init(leaves, "int8")
    q8_m = sr_adam.sr_adam_init(leaves, "int8_m")
    assert not kernel.fused_update_applies(leaves, mirror)
    cuda = [_CudaStandIn()]
    assert kernel.fused_update_applies(cuda, mirror)
    assert not kernel.fused_update_applies(cuda, q8)
    assert not kernel.fused_update_applies(cuda, q8_m)
    with pytest.raises(TypeError):
        kernel.FusedSRAdam(leaves, q8)
    with pytest.raises(ValueError):
        kernel.FusedSRAdam(leaves, mirror)  # no kernel on the CPU


@pytest.mark.parametrize("moment_dtype", ["float32", "int8"])
def test_round_step_on_the_cpu_launches_nothing(moment_dtype):
    rnd, model, ds = _round("DirectPred", moment_dtype=moment_dtype)
    before = kernel.FusedSRAdam.launches
    data = model.make_batch(ds)
    rnd.step(_gather(data, torch.arange(8)))
    assert kernel.FusedSRAdam.launches == before
    assert rnd.fused is None and rnd.count == 1


def test_fma_rn_rounds_once_where_the_float64_route_rounds_twice():
    # the exact sums lie 2^-54 below the float32 midpoints 1 + 2^-23 + 2^-24:
    # float64 rounds them onto the midpoint, float32 then to even (up); once
    # rounded, they go down
    a = torch.tensor([1.0, -1.0]) * 2 ** -24 * (1 + 2 ** -15)
    b = 1 - 2 ** -15
    c = torch.tensor([1.0, -1.0]) * (1 + 2 ** -23)
    assert sr_adam._fma(a, b, c).tolist() == [1 + 2 ** -22, -(1 + 2 ** -22)]
    assert kernel.fma_rn(a, b, c).tolist() == [1 + 2 ** -23, -(1 + 2 ** -23)]
    g = torch.Generator().manual_seed(3)
    a, c = torch.randn(10000, generator=g), torch.randn(10000, generator=g)
    assert torch.equal(kernel.fma_rn(a, 0.8999999761581421, c), sr_adam._fma(a, 0.8999999761581421, c))


@pytest.mark.parametrize("trial_axis", [False, True])
def test_global_norm_f64_is_the_float32_norm_on_exact_squares(trial_axis):
    g = torch.Generator().manual_seed(4)
    tree = [torch.randn(3, 300, 40, generator=g), torch.randn(3, 77, generator=g)]
    exact = [torch.sign(x) * (x.abs() > 0.5) * 2.0 ** -4 for x in tree]
    want = sr_adam.global_norm_f32(exact, trial_axis)
    assert torch.equal(kernel.global_norm_f64(exact, trial_axis), want)
    # otherwise within a float32 rounding of the float32 chain's
    got, plain = kernel.global_norm_f64(tree, trial_axis), sr_adam.global_norm_f32(tree, trial_axis)
    torch.testing.assert_close(got, plain, rtol=1e-6, atol=0)
