"""How kernels B1, B2 and B3 of the port cut their work, in pure Python that
runs without a card: B1's and B2's planners (``kernels/fused_linear.py::
plan_b1`` and ``plan_b2``: the cluster size and slice of F per launch) and
B3's enumeration of the tiles of
its pair sets (``kernels/mmd.py::decode_tile``, the mirror of the kernel's
``decode_tile``); and the name of a built library, which must change with
any header the sources share. The kernels themselves run in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``."""

import itertools

import pytest

from flexynesis_torch.kernels import build
from flexynesis_torch.kernels.fused_linear import (
    B2_COL_TILE,
    B2_CTAS_PER_SM,
    B2_K_STAGE,
    COL_TILE,
    H100_SMS,
    K_STAGE,
    MAX_SPLIT,
    MIN_SLICE,
    ROW_TILE,
    plan_b1,
    plan_b2,
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


def _check_slices(plan, F, k_stage):
    """The slices of ``plan`` are whole stages and cover F exactly once."""
    assert plan.split in (1, 2, 4, 8)
    assert plan.slice % k_stage == 0
    covered = []
    for r in range(plan.split):  # CTA r's depth, as the kernel computes it
        begin = min(F, r * plan.slice)
        covered += range(begin, min(F, begin + plan.slice))
    assert covered == list(range(F))
    if plan.split > 1:  # no CTA of a split cluster is idle or shallow
        assert F - (plan.split - 1) * plan.slice > 0
        assert -(-F // plan.split) >= MIN_SLICE


@pytest.mark.parametrize("B,F,H", PATH_SHAPES + OTHER_SHAPES)
def test_slices_cover_f_exactly_once(B, F, H):
    plan = plan_b1(B, F, H)
    assert COL_TILE % plan.split == 0
    assert plan.tiles == -(-B // ROW_TILE) * -(-H // COL_TILE)
    _check_slices(plan, F, K_STAGE)


@pytest.mark.parametrize("sms,want", [(1, 1), (19, 1), (38, 2), (132, 8), (1000, 8)])
def test_split_follows_the_sm_count_up_to_the_portable_cluster(sms, want):
    assert plan_b1(64, 2000, 600, sms).split == want  # 19 tiles of h


def test_planner_reaches_every_cluster_size():
    # the cluster sizes chip_smoke.py and the card tests exercise
    assert [plan_b1(64, F, 600).split for F in (64, 128, 256, 2000)] == [1, 2, 4, 8]


# ------------------------------------------------------------------ B2 plans

# (F, H) of the three B2 calls of one DirectPred eval forward at the headline
# width, and the batch sizes the paths give them: a 64-row request, the
# 400-row validation split, the 500-row test cohort, the 2000-row cohort
B2_BLOCKS = [(2000, 600), (1000, 300), (64, 16)]
B2_ROWS = [64, 400, 500, 2000]
B2_PATH = [(B, F, H) for B in B2_ROWS for F, H in B2_BLOCKS]


@pytest.mark.parametrize("B,F,H", B2_PATH)
def test_b2_grid_has_at_least_the_one_block_per_tile_grid(B, F, H):
    plan = plan_b2(B, F, H)
    assert plan.tiles == _old_grid(B, H)  # 64 x 64 tiles of y, as before the split
    assert plan.ctas >= _old_grid(B, H)


@pytest.mark.parametrize("B,F,H,split", [
    *[(B, F, H, 8) for B in (64, 400, 500) for F, H in B2_BLOCKS[:2]],
    (2000, 2000, 600, 2), (2000, 1000, 300, 4),   # 320 and 160 tiles for 396 slots
    *[(B, 64, 16, 1) for B in B2_ROWS]])           # the 64-deep head
def test_b2_split_at_each_path_shape(B, F, H, split):
    assert plan_b2(B, F, H).split == split


@pytest.mark.parametrize("B", B2_ROWS)
def test_b2_grids_are_split_until_they_fill_every_slot(B):
    slots = B2_CTAS_PER_SM * H100_SMS
    for F, H in B2_BLOCKS[:2]:
        plan = plan_b2(B, F, H)
        assert plan.tiles < slots and (plan.ctas >= slots or plan.split == MAX_SPLIT)


@pytest.mark.parametrize("B,F,H", B2_PATH + OTHER_SHAPES)
def test_b2_slices_cover_f_exactly_once(B, F, H):
    plan = plan_b2(B, F, H)
    assert B2_COL_TILE % plan.split == 0
    assert plan.tiles == -(-B // ROW_TILE) * -(-H // B2_COL_TILE)
    _check_slices(plan, F, B2_K_STAGE)


@pytest.mark.parametrize("planner,k_stage", [(plan_b1, K_STAGE), (plan_b2, B2_K_STAGE)])
def test_no_cta_of_a_cluster_is_idle_at_any_depth(planner, k_stage):
    # rounding slices up to whole stages must never leave the last rank
    # without depth (F = 513 at split 8 would, with 96-deep slices of B2)
    for F in range(0, 4097):
        _check_slices(planner(64, F, 600), F, k_stage)


def test_b2_planner_reaches_every_cluster_size():
    # the cluster sizes chip_smoke.py and the card tests exercise
    assert [plan_b2(64, F, 600).split for F in (64, 128, 256, 2000)] == [1, 2, 4, 8]


@pytest.mark.parametrize("sms,want", [(1, 1), (3, 1), (4, 2), (7, 4), (132, 8)])
def test_b2_split_follows_the_sm_count(sms, want):
    assert plan_b2(64, 2000, 600, sms).split == want  # 10 tiles of y, 3 slots per SM


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
    for name in ("fused_linear_eval", "fused_linear_train", "mmd_kernel"):
        assert '#include "cp_async.cuh"' in (build.CSRC_DIR / f"{name}.cu").read_text()


# the trial axis: K trials of one launch count together in the planners' tiles


@pytest.mark.parametrize("planner", [plan_b1, plan_b2])
@pytest.mark.parametrize("B,F,H", PATH_SHAPES + OTHER_SHAPES)
def test_one_trial_plans_as_the_call_without_the_axis(planner, B, F, H):
    assert planner(B, F, H, H100_SMS, 1) == planner(B, F, H, H100_SMS)


@pytest.mark.parametrize("K", [2, 3, 16])
@pytest.mark.parametrize("B,F,H", PATH_SHAPES + OTHER_SHAPES)
def test_trials_multiply_the_tiles(K, B, F, H):
    for planner, col_tile in ((plan_b1, COL_TILE), (plan_b2, B2_COL_TILE)):
        plan = planner(B, F, H, H100_SMS, K)
        assert plan.tiles == K * -(-B // ROW_TILE) * -(-H // col_tile)
        # more trials never split F further
        assert plan.split <= planner(B, F, H, H100_SMS).split


@pytest.mark.parametrize("B,F,H,split", [
    (64, 2000, 600, 1),  # 16 x 19 = 304 CTAs: the card is full without a split
    (64, 1000, 300, 1),  # 160 CTAs
    (64, 64, 16, 1),     # the head: too shallow to split
])
def test_b1_sixteen_trials_of_the_training_step(B, F, H, split):
    plan = plan_b1(B, F, H, H100_SMS, 16)
    assert plan.split == split and plan.ctas == plan.tiles * split


@pytest.mark.parametrize("B,F,H,tiles", [
    (400, 2000, 600, 1120),  # 16 x 70 tiles: more than the 3 x 132 slots
    (400, 1000, 300, 560),
    (400, 64, 16, 112),      # the head: too shallow to split
])
def test_b2_sixteen_trials_of_a_validation_keep_split_one(B, F, H, tiles):
    plan = plan_b2(B, F, H, H100_SMS, 16)
    assert plan.split == 1 and plan.tiles == tiles


@pytest.mark.parametrize("K", [1, 3, 16])
def test_trial_plans_keep_covering_f(K):
    for B, F, H in PATH_SHAPES + OTHER_SHAPES:
        _check_slices(plan_b1(B, F, H, H100_SMS, K), F, K_STAGE)
        _check_slices(plan_b2(B, F, H, H100_SMS, K), F, B2_K_STAGE)
