"""How kernels B1 and B3 of the port cut their work, in pure Python that runs
without a card: B1's planner (``kernels/fused_linear.py::plan_b1``: the
cluster size and slice of F per launch) and B3's enumeration of the tiles of
its pair sets (``kernels/mmd.py::decode_tile``, the mirror of the kernel's
``decode_tile``); and the name of a built library, which must change with
any header the sources share. The kernels themselves run in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``."""

import itertools

import pytest

from flexynesis_torch.kernels import build
from flexynesis_torch.kernels.fused_linear import (
    COL_TILE,
    K_STAGE,
    MAX_SPLIT,
    MIN_SLICE,
    ROW_TILE,
    plan_b1,
)
from flexynesis_torch.kernels.mmd import (
    TILE,
    call_tiles,
    decode_tile,
    pair_tiles,
    term_sets,
)

# (B, F, H) of the DirectPred training forward at the headline width:
# the gex and cnv encoders and the 16-wide head
PATH_SHAPES = [(64, 2000, 600), (64, 1000, 300), (64, 64, 16)]
ENCODERS = PATH_SHAPES[:2]
OTHER_SHAPES = [(32, 2000, 600), (128, 2000, 600), (4096, 2000, 600), (37, 129, 67),
                (1, 64, 16), (1, 1, 1), (64, 0, 5), (64, 1999, 601), (64, 128, 600),
                (64, 256, 600), (2100, 64, 16), (130, 300, 257)]


def _old_grid(B, H):
    """Blocks of the kernel before the split: one per 64 x 64 tile of h."""
    return -(-B // 64) * -(-H // 64)


@pytest.mark.parametrize("B,F,H", ENCODERS)
def test_encoder_shapes_fill_more_of_the_card_than_the_old_grid(B, F, H):
    plan = plan_b1(B, F, H)
    assert plan.split == MAX_SPLIT
    assert plan.ctas > 7 * _old_grid(B, H)


def test_every_path_shape_fills_at_least_the_old_grid():
    assert all(plan_b1(*s).ctas >= _old_grid(s[0], s[2]) for s in PATH_SHAPES)


@pytest.mark.parametrize("B,F,H", [(64, 64, 16), (1, 64, 16), (64, 127, 600), (64, 0, 5),
                                   (4096, 2000, 600)])
def test_small_depth_or_many_tiles_keep_split_one(B, F, H):
    assert plan_b1(B, F, H).split == 1


@pytest.mark.parametrize("B,F,H", PATH_SHAPES + OTHER_SHAPES)
def test_slices_cover_f_exactly_once(B, F, H):
    plan = plan_b1(B, F, H)
    assert plan.split in (1, 2, 4, 8) and COL_TILE % plan.split == 0
    assert plan.slice % K_STAGE == 0
    assert plan.tiles == -(-B // ROW_TILE) * -(-H // COL_TILE)
    covered = []
    for r in range(plan.split):  # CTA r's depth, as the kernel computes it
        begin = min(F, r * plan.slice)
        covered += range(begin, min(F, begin + plan.slice))
    assert covered == list(range(F))
    if plan.split > 1:  # no CTA of a split cluster is idle or shallow
        assert F - (plan.split - 1) * plan.slice > 0
        assert -(-F // plan.split) >= MIN_SLICE


@pytest.mark.parametrize("sms,want", [(1, 1), (19, 1), (38, 2), (132, 8), (1000, 8)])
def test_split_follows_the_sm_count_up_to_the_portable_cluster(sms, want):
    assert plan_b1(64, 2000, 600, sms).split == want  # 19 tiles of h


def test_planner_reaches_every_cluster_size():
    # the cluster sizes chip_smoke.py and the card tests exercise
    assert [plan_b1(64, F, 600).split for F in (64, 128, 256, 2000)] == [1, 2, 4, 8]


# ------------------------------------------------------------------ B3 tiles

TERM_SHAPES = [(200, 64), (200, 400), (64, 64), (1, 1), (37, 129), (65, 200), (4096, 70)]


def _valid(t, n):
    return min(TILE, n - t * TILE)


@pytest.mark.parametrize("n,m,self_pairs", [(200, 200, True), (64, 64, True), (1, 1, True),
                                            (400, 400, True), (4096, 4096, True),
                                            (200, 64, False), (37, 129, False)])
def test_tiles_cover_each_pair_once_with_their_weights(n, m, self_pairs):
    tiles = [decode_tile(t, n, m, self_pairs) for t in range(pair_tiles(n, m, self_pairs))]
    tn, tm = -(-n // TILE), -(-m // TILE)
    if self_pairs:
        assert sorted((i, j) for i, j, _ in tiles) == [
            (i, j) for i in range(tn) for j in range(i, tn)]
        assert all(w == (1 if i == j else 2) for i, j, w in tiles)
    else:
        assert [(i, j) for i, j, _ in tiles] == list(itertools.product(range(tn), range(tm)))
        assert all(w == 1 for *_, w in tiles)
    assert sum(w * _valid(i, n) * _valid(j, m) for i, j, w in tiles) == n * m


@pytest.mark.parametrize("n,m", TERM_SHAPES)
def test_an_mmd_term_counts_n_n_m_m_and_n_m_pairs(n, m):
    counts = []
    for a, b, self_pairs in term_sets(n, m):
        counts.append(sum(w * _valid(i, a) * _valid(j, b) for i, j, w in
                          (decode_tile(t, a, b, self_pairs)
                           for t in range(pair_tiles(a, b, self_pairs)))))
    assert counts == [n * n, m * m, n * m]
    assert call_tiles(n, m, term=True) == sum(pair_tiles(*s) for s in term_sets(n, m))


def test_the_self_sets_halve_the_tiles_of_the_training_term():
    # the prior of 200 draws against the 64-row batch: 10 + 1 + 4 blocks,
    # where three full calls would run 16 + 1 + 4
    assert call_tiles(200, 64, term=True) == 15
    assert call_tiles(200, 200, term=False) == 16
    assert call_tiles(200, 400, term=True) == 10 + 28 + 28


def test_upper_triangle_decoding_is_exact_at_large_counts():
    n = 64 * 3000  # 3000 tiles a side: 4.5 million tiles
    count = pair_tiles(n, n, True)
    for t in (0, 1, 2999, 3000, count // 2, count - 2, count - 1):
        i, j, _ = decode_tile(t, n, n, True)
        assert 0 <= i <= j < 3000
        assert i * 3000 - i * (i - 1) // 2 + (j - i) == t


# ------------------------------------------------------------------ the build


def test_library_hash_covers_the_source_and_every_header(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    (tmp_path / "k.cu").write_text('#include "shared.cuh"\n')
    (tmp_path / "shared.cuh").write_text("// v1\n")
    first = build.library_path("k")
    assert first.name.startswith("k-") and first == build.library_path("k")
    names = {first}
    for path, text in (("shared.cuh", "// v2\n"), ("k.cu", "// edited\n"),
                       ("sub/other.cuh", "// new\n")):
        (tmp_path / path).parent.mkdir(exist_ok=True)
        (tmp_path / path).write_text(text)
        names.add(build.library_path("k"))
    assert len(names) == 4


def test_the_port_sources_share_a_header():
    assert (build.CSRC_DIR / "cp_async.cuh").exists()
    for name in ("fused_linear_train", "mmd_kernel"):
        assert '#include "cp_async.cuh"' in (build.CSRC_DIR / f"{name}.cu").read_text()
