r"""The port's group route and its twin vs the JAX functions.

``ops/route.py``'s plain versions (what the wrappers run for CPU tensors)
are held exactly to ``bblean_tpu/engine/batch.py::_route_groups`` and
``bblean_tpu/parallel/sharded.py::_best_group_sim``: routed groups equal,
best sims bit-equal.  The cases cover several blocks with a partial last
one, the clamped last block of ``lax.dynamic_slice`` (``block`` not
dividing the table), a block wider than the table, no, one and every
group live, duplicate centroids in different blocks, pending masks with
holes, an all-zero row against an all-zero centroid (the union clamps to
1), and widths of 2048, 264 and 100 bits.  The CUDA kernel itself runs
only on a card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 2d),
where it is held to these plain versions; here are the unit planner that
cuts its work (``route._plan``) and the near-tie inputs its card tests use.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bblean_tpu.engine import batch as jb
from bblean_tpu.parallel import sharded as js
import chip_smoke
from bblean_tpu_torch.engine import batch as tb
from bblean_tpu_torch.ops import route
from bblean_tpu_torch.parallel import sharded as ts

torch.set_num_threads(2)

M = 37  # rows: not a multiple of 8 (the plain version pads for _int_mm)

# (F, G_cap, g_num, block)
CASES = [
    (2048, 64, 45, 16),  # several blocks, the last one partial
    (2048, 64, 60, 24),  # the clamped last block
    (2048, 64, 64, 24),  # clamped, every group live
    (264, 64, 50, 128),  # block wider than the table
    (264, 64, 64, 16),  # every group live
    (100, 64, 0, 16),  # no live group
    (100, 64, 1, 16),  # one live group
    (100, 64, 33, 8),
]


def _case(f: int, g_cap: int, seed: int):
    r"""numpy inputs: 0/1 rows and centroids at 20% density; centroid 3
    copied at 20, 41 and 59 (ties in other blocks), centroid 7 all zero;
    a third of the rows are copies of centroid 3, row 5 is all zero, and
    every third row is not pending."""
    rng = np.random.default_rng(seed)
    rows = (rng.random((M, f)) < 0.2).astype(np.int8)
    cent = (rng.random((g_cap, f)) < 0.2).astype(np.int8)
    cent[[20, 41, 59]] = cent[3]
    cent[7] = 0
    rows[1::3] = cent[3]
    rows[5] = 0
    pending = np.ones(M, bool)
    pending[::3] = False
    pending[0] = True
    return (
        rows, rows.sum(1).astype(np.int32), cent, cent.sum(1).astype(np.int32),
        pending,
    )


def _ids(case) -> str:
    return "F{}-G{}-live{}-block{}".format(*case)


_jax_route = jax.jit(jb._route_groups, static_argnames=("block",))
_jax_best = jax.jit(js._best_group_sim, static_argnames=("block",))


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_route_groups_plain_matches_jax(case) -> None:
    f, g_cap, g_num, block = case
    rows, pops, cent, cpops, pending = _case(f, g_cap, f + g_num + block)
    ref = np.asarray(_jax_route(
        jnp.asarray(rows), jnp.asarray(pops), jnp.asarray(cent),
        jnp.asarray(cpops), jnp.int32(g_num), jnp.asarray(pending), block=block,
    ))
    got = route.route_groups_plain(
        *map(torch.from_numpy, (rows, pops, cent, cpops)), g_num,
        torch.from_numpy(pending), block,
    )
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (ref[~pending] == 0).all()
    if g_num > 3:  # copies of centroid 3 tie at 1.0: the first column wins
        assert (ref[1::3][pending[1::3]] == 3).all()


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_best_group_sim_plain_matches_jax(case) -> None:
    f, g_cap, g_num, block = case
    rows, pops, cent, cpops, _pending = _case(f, g_cap, 7 * f + g_num + block)
    ref = np.asarray(_jax_best(
        jnp.asarray(rows), jnp.asarray(pops), jnp.asarray(cent),
        jnp.asarray(cpops), jnp.int32(g_num), block=block,
    ))
    got = route.best_group_sim_plain(
        *map(torch.from_numpy, (rows, pops, cent, cpops)), g_num, block,
    )
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.int32), ref.view(np.int32))
    if g_num == 0:
        assert (ref == -2.0).all()
    elif g_num > 3:
        assert (ref[1::3] == 1.0).all()


def test_wrappers_take_the_plain_versions_for_cpu_tensors(monkeypatch) -> None:
    r"""CPU tensors go to the plain versions and launch nothing."""
    rows, pops, cent, cpops, pending = map(torch.from_numpy, _case(264, 64, 1))
    seen = []

    def spy(fn):
        def call(*a):
            seen.append(fn.__name__)
            return fn(*a)
        return call

    monkeypatch.setattr(route, "route_groups_plain", spy(route.route_groups_plain))
    monkeypatch.setattr(route, "best_group_sim_plain", spy(route.best_group_sim_plain))
    monkeypatch.setattr(route, "_launch", lambda *a: pytest.fail("launched on the CPU"))
    before = (route.route_launches, route.best_sim_launches, route.generic_launches)
    route.route_groups(rows, pops, cent, cpops, 50, pending, 16)
    route.best_group_sim(rows, pops, cent, cpops, 50, 16)
    assert seen == ["route_groups_plain", "best_group_sim_plain"]
    assert (route.route_launches, route.best_sim_launches, route.generic_launches) == before


def test_engine_and_merge_go_through_ops_route(monkeypatch) -> None:
    r"""``engine/batch.py::_route_groups`` and
    ``parallel/sharded.py::_best_group_sim`` call the wrappers of
    ``ops/route.py`` with their arguments unchanged."""
    args = tuple(map(torch.from_numpy, _case(100, 64, 2)))
    calls = []
    monkeypatch.setattr(route, "route_groups", lambda *a: calls.append(("route", a)) or "r")
    monkeypatch.setattr(route, "best_group_sim", lambda *a: calls.append(("best", a)) or "b")
    assert tb._route_groups(*args[:4], 33, args[4], 8) == "r"
    assert ts._best_group_sim(*args[:4], 33, 8) == "b"
    assert [c[0] for c in calls] == ["route", "best"]
    assert calls[0][1][4:] == (33, args[4], 8) and calls[1][1][4:] == (33, 8)


@pytest.mark.parametrize("g_cap,block", [(64, 24), (64, 16), (64, 128), (1000, 1024), (65536, 1000)])
def test_last_block_maps_columns_like_dynamic_slice(g_cap, block) -> None:
    r"""The kernel's column-to-row map (``_last_block``: rows shifted in
    the last block only) equals the plain version's clamped slices for
    every live column, at every live count."""
    eff = min(block, g_cap)
    for g_num in sorted({1, 2, eff - 1, eff, eff + 1, g_cap - 1, g_cap} & set(range(1, g_cap + 1))):
        start, shift = route._last_block(g_cap, g_num, block)
        c = np.arange(g_num)
        b = c // eff
        want = np.minimum(b * eff, g_cap - eff) + c - b * eff
        got = c + np.where(c >= start, shift, 0)
        np.testing.assert_array_equal(got, want)
        assert got.max() < g_cap


def _plan_ranges(plan, g_num: int, shift: int) -> list[tuple[int, int, int]]:
    r"""(first column, end column, row shift) of each range of ``plan``, in
    order: what ``csrc/route.cu``'s ``range_of`` gives range ``s``."""
    out = []
    for s in range(plan.n_ranges):
        if s < plan.s1:
            c0 = s * plan.span
            out.append((c0, min(c0 + plan.span, plan.seg1_end), 0))
        else:
            c0 = plan.seg1_end + (s - plan.s1) * plan.span
            out.append((c0, min(c0 + plan.span, g_num), shift))
    return out


def _check_plan(m: int, g_cap: int, g_num: int, block: int, n_sm: int):
    r"""The unit plan of one call against its contract: the ranges hold every
    live column once, in column order; each is a whole number of column
    tiles but the last of its segment; none straddles the clamped last
    block's first column; the shifted rows are those of ``_last_block``;
    the grid is min(units, SMs)."""
    last_start, shift = route._last_block(g_cap, g_num, block)
    plan = route._plan(m, g_num, last_start, shift, n_sm)
    ranges = _plan_ranges(plan, g_num, shift)
    assert len(ranges) == plan.n_ranges >= 1
    assert plan.span % route.TILE_COLS == 0
    assert ranges[0][0] == 0 and ranges[-1][1] == g_num
    for (c0, c1, sh), nxt in zip(ranges, ranges[1:] + [None]):
        assert c0 < c1 <= c0 + plan.span
        if nxt is not None:
            assert nxt[0] == c1  # contiguous, in column order
            assert c1 - c0 == plan.span or c1 == last_start
        assert not c0 < last_start < c1 or shift == 0  # no straddle
        assert sh == (shift if c0 >= last_start else 0)
    row_tiles = -(-m // route.TILE_ROWS)
    assert plan.units == row_tiles * plan.n_ranges
    assert plan.grid == min(plan.units, n_sm)
    return plan, ranges


@pytest.mark.parametrize(
    "m,g_cap,block,n_sm",
    [(8192, 65536, 1024, 132), (8192, 65536, 1000, 132), (16384, 16384, 1024, 132),
     (37, 64, 24, 132), (20000, 4096, 1024, 132), (8191, 65536, 1000, 114)],
)
def test_chunks_cover_the_live_columns(m, g_cap, block, n_sm) -> None:
    r"""The chunks of the live columns are the unit plan's column ranges
    (``route._plan``).  From 1 live group to the whole table (65,536 at the
    engine's shapes), every live column lies in exactly one range, in
    column order, and no range straddles the clamped last block."""
    lives = {1, 2, 255, 256, 257, 755, 1000, 1646, 4096, 17364, 22000, 43008, 65000, 65001, g_cap}
    for g_num in sorted(g for g in lives if g <= g_cap):
        _check_plan(m, g_cap, g_num, block, n_sm)


def test_plan_splits_at_a_last_start_no_tile_divides() -> None:
    r"""Block 1000 of a 65,536-group table: the last block starts at 65,000
    (no multiple of 256) and reads rows shifted by -464; a range boundary
    falls there and the shifted range starts at it."""
    plan, ranges = _check_plan(8192, 65536, 65536, 1000, 132)
    assert route._last_block(65536, 65536, 1000) == (65000, -464)
    assert (65000, 65536, -464) in ranges and plan.seg1_end == 65000
    assert all(sh == 0 for c0, _c1, sh in ranges if c0 < 65000)


@pytest.mark.parametrize("g_num,units", [(1646, 128), (43008, 128), (755, 128)])
def test_plan_fills_the_card(g_num, units) -> None:
    r"""At the 1M fit's average route (1,646 groups: 7 column tiles), at the
    10M fits' final groups and at the merge's shape, the units take 128 of
    132 SMs at once, one unit each: no block waits on a second wave."""
    m = 16384 if g_num == 755 else 8192
    plan, _ranges = _check_plan(m, 65536, g_num, 1024, 132)
    assert plan.units == units and plan.grid == units


def test_plan_has_more_units_than_sms_where_that_balances() -> None:
    r"""Every group live (256 column tiles): more units than SMs, in waves
    that leave the SMs within one unit of each other."""
    plan, _ranges = _check_plan(8192, 65536, 65536, 1024, 132)
    assert plan.units > 132 and plan.grid == 132
    waves = -(-plan.units // 132)
    assert waves * plan.span // route.TILE_COLS <= 256 * 64 / 132 + plan.span // route.TILE_COLS


def test_near_tie_helper_gives_distinct_fractions_with_one_f32() -> None:
    r"""``chip_smoke.route_near_tie``: two Tanimoto fractions that differ
    exactly but whose IEEE f32 quotients are equal (numpy and torch), with
    unions within the rows' 8192 bits, so the card's near-tie test is not
    vacuous; none exists with unions of at most 4096."""
    from fractions import Fraction

    i1, u1, i2, u2 = chip_smoke.route_near_tie(8192)
    assert Fraction(i1, u1) < Fraction(i2, u2) and max(u1, u2) <= 8192
    f32 = np.float32
    assert f32(i1) / f32(u1) == f32(i2) / f32(u2)
    t = torch.tensor([i1, i2], dtype=torch.float32) / torch.tensor([u1, u2], dtype=torch.float32)
    assert t[0].item() == t[1].item()
    with pytest.raises(ValueError, match="no near tie"):
        chip_smoke.route_near_tie(4096)


@pytest.mark.parametrize("cols", [(10, 20), (20, 10), (3, 60)])
def test_near_tie_keeps_the_earlier_column_in_jax_and_plain(cols) -> None:
    r"""On the near-tie inputs (8192-bit rows; the even rows meet
    ``cols[0]`` in the smaller exact fraction and ``cols[1]`` in the larger,
    equal in f32) the JAX route and the plain version both give the even
    pending rows the earlier column, and the same best sims."""
    rows, pops, cent, cpops, pending = chip_smoke.route_near_tie_inputs(
        np.random.default_rng(1), 6, 8192, 64, cols,
    )
    i1, u1, i2, u2 = chip_smoke.route_near_tie(8192)
    assert (rows[0] @ cent[cols[0]].astype(np.int64), rows[0].sum() + cpops[cols[0]] - i1) == (i1, u1)
    assert (rows[0] @ cent[cols[1]].astype(np.int64), rows[0].sum() + cpops[cols[1]] - i2) == (i2, u2)
    ref = np.asarray(_jax_route(
        jnp.asarray(rows), jnp.asarray(pops), jnp.asarray(cent), jnp.asarray(cpops),
        jnp.int32(64), jnp.asarray(pending), block=32,
    ))
    got = route.route_groups_plain(
        *map(torch.from_numpy, (rows, pops, cent, cpops)), 64, torch.from_numpy(pending), 32,
    )
    np.testing.assert_array_equal(got.numpy(), ref)
    even = pending.copy()
    even[1::2] = False
    assert (ref[even] == min(cols)).all()
    ref_sim = np.asarray(_jax_best(
        jnp.asarray(rows), jnp.asarray(pops), jnp.asarray(cent), jnp.asarray(cpops),
        jnp.int32(64), block=32,
    ))
    sim = route.best_group_sim_plain(*map(torch.from_numpy, (rows, pops, cent, cpops)), 64, 32)
    np.testing.assert_array_equal(sim.numpy().view(np.int32), ref_sim.view(np.int32))
    assert (ref_sim[0::2] == np.float32(i1) / np.float32(u1)).all()
