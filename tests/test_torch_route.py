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
where it is held to these plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bblean_tpu.engine import batch as jb
from bblean_tpu.parallel import sharded as js
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


def test_wrappers_raise_off_cpu_without_the_kernel() -> None:
    r"""Tensors on a device other than the CPU go to the kernel, never to
    the plain versions: here ("meta" tensors) the wrappers raise."""
    meta = [torch.from_numpy(a).to("meta") for a in _case(100, 64, 3)]
    with pytest.raises(ValueError, match="one CUDA device"):
        route.route_groups(*meta[:4], 33, meta[4], 8)
    with pytest.raises(ValueError, match="one CUDA device"):
        route.best_group_sim(*meta[:4], 33, 8)


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


@pytest.mark.parametrize(
    "m,g_num,resident",
    [(8192, 43008, 264), (8192, 17364, 264), (8192, 1, 264), (65536, 20000, 264), (1, 128, 264), (300, 65536, 132)],
)
def test_chunks_cover_the_live_columns(m, g_num, resident) -> None:
    r"""The chunks on the grid's second axis cover every live column tile
    once, none is empty, and the grid stays within the resident blocks
    (one chunk at least)."""
    n, per = route._chunks(m, g_num, resident)
    col_tiles = -(-g_num // route.TILE_COLS)
    row_tiles = -(-m // route.TILE_ROWS)
    assert 1 <= n <= col_tiles and per >= 1
    assert (n - 1) * per < col_tiles <= n * per
    assert n == 1 or row_tiles * n <= resident
