r"""The port's sorted tile search vs the JAX search.

The port's plain version (what the wrapper runs for CPU tensors) is held to
the Pallas kernel in interpret mode (``tile_search_sorted(interpret=True)``,
as ``tests/test_pallas_search_sorted.py`` runs it) and to the XLA gather
``_search_tiles``.  Contract: equal sims for every row (bit for bit), equal
slots wherever ``sim > -1.5``.  The CUDA kernel itself runs only on a card,
where ``chip_smoke.py`` holds it to this plain version.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bblean_tpu.engine.batch import _search_tiles
from bblean_tpu.ops.pallas_search2 import (
    sorted_search_plan as jax_plan,
    tile_search_planned as jax_planned,
    tile_search_sorted as jax_sorted,
)
from bblean_tpu_torch import _build
from bblean_tpu_torch.ops import tile_search as ts

torch.set_num_threads(2)


def _mk(rng, m, g, fc, f8, concentration, guard=False):
    r"""numpy inputs, built like ``test_pallas_search_sorted._mk``."""
    t_pk = rng.integers(0, 256, (g, fc, f8), dtype=np.uint8)
    occ = rng.random((g, fc)) < 0.7
    if guard:  # the last tile is the engine's empty guard
        occ[g - 1] = False
    t_slot = np.where(occ, rng.integers(0, 10_000, (g, fc)), -1).astype(np.int32)
    t_pk[~occ] = 0
    t_pops = (
        np.unpackbits(t_pk.reshape(g * fc, f8), axis=1)
        .sum(1).astype(np.int32).reshape(g, fc)
    )
    row_pk = rng.integers(0, 256, (m, f8), dtype=np.uint8)
    row_pop = np.unpackbits(row_pk, axis=1).sum(1).astype(np.int32)
    if concentration == "one":
        row_group = np.zeros(m, np.int32)
    elif concentration == "spread":
        row_group = rng.integers(0, g - 1 if guard else g, m).astype(np.int32)
    else:
        row_group = np.sort(rng.integers(0, 3, m)).astype(np.int32)
    pending = rng.random(m) < 0.8
    return row_pk, row_pop, row_group, t_pk, t_pops, t_slot, pending


def _assert_contract(ref, got) -> None:
    ref_sim, ref_slot = (np.asarray(x) for x in ref)
    got_sim, got_slot = (np.asarray(x) for x in got)
    assert got_sim.dtype == np.float32 and got_slot.dtype == np.int32
    np.testing.assert_array_equal(ref_sim, got_sim)
    has_cand = ref_sim > -1.5
    np.testing.assert_array_equal(ref_slot[has_cand], got_slot[has_cand])


def _port_sorted(args, guard_group=None):
    return ts.tile_search_sorted(
        *(torch.from_numpy(a) for a in args), guard_group=guard_group
    )


@pytest.mark.parametrize(
    "m,g,fc,f8,concentration",
    [
        (64, 8, 16, 32, "one"),
        (64, 8, 16, 32, "few"),
        (64, 8, 16, 32, "spread"),
        (128, 32, 8, 8, "spread"),
        (256, 4, 32, 32, "few"),
        (64, 8, 16, 33, "few"),  # byte tail: F8 % 8 != 0
    ],
)
def test_plain_search_matches_jax(m, g, fc, f8, concentration) -> None:
    rng = np.random.default_rng(m + g + fc)
    args = _mk(rng, m, g, fc, f8, concentration)
    jargs = tuple(map(jnp.asarray, args))
    got = _port_sorted(args)
    _assert_contract(_search_tiles(*jargs), got)
    _assert_contract(jax_sorted(*jargs, interpret=True), got)
    _assert_contract(
        _search_tiles(*jargs),
        ts.search_tiles_plain(*(torch.from_numpy(a) for a in args)),
    )


def test_plain_search_all_empty_tiles() -> None:
    r"""Empty tiles everywhere -> sim -2, slot clamped to 0."""
    m, g, fc, f8 = 32, 4, 8, 16
    args = list(_mk(np.random.default_rng(0), m, g, fc, f8, "spread"))
    args[5] = np.full((g, fc), -1, np.int32)
    got_sim, got_slot = _port_sorted(args)
    ref_sim, ref_slot = jax_sorted(*map(jnp.asarray, args), interpret=True)
    np.testing.assert_array_equal(got_sim.numpy(), np.asarray(ref_sim))
    assert (got_sim.numpy() == -2.0).all()
    assert (got_slot.numpy() == 0).all() and (np.asarray(ref_slot) == 0).all()


def test_plain_search_guard_group_path() -> None:
    r"""The engine's path: non-pending rows keyed to the reserved empty
    guard tile."""
    m, g, fc, f8 = 64, 8, 16, 32
    args = _mk(np.random.default_rng(11), m, g, fc, f8, "few", guard=True)
    jargs = tuple(map(jnp.asarray, args))
    got = _port_sorted(args, guard_group=g - 1)
    _assert_contract(_search_tiles(*jargs), got)
    _assert_contract(
        jax_sorted(*jargs, interpret=True, guard_group=g - 1), got
    )


def test_planned_search_with_stale_plan_matches_jax() -> None:
    r"""The plan is made once per step with the initial pending mask and
    reused while ``pending`` shrinks; rows assigned since are masked."""
    m, g, fc, f8 = 64, 8, 16, 32
    args = _mk(np.random.default_rng(23), m, g, fc, f8, "few", guard=True)
    row_pk, row_pop, row_group, t_pk, t_pops, t_slot, _pending = args
    guard = g - 1
    pending0 = np.ones(m, bool)
    pending0[::7] = False  # padding rows, keyed to the guard at plan time
    pending_now = pending0.copy()
    pending_now[1::3] = False  # assigned in an earlier round

    key = np.where(pending0, row_group, guard)
    order, skey, items = ts.sorted_search_plan(torch.from_numpy(key))
    tt = {k: torch.from_numpy(v) for k, v in dict(
        row_pk=row_pk, row_pop=row_pop, t_pk=t_pk, t_pops=t_pops,
        t_slot=t_slot, pend=pending_now,
    ).items()}
    got = ts.tile_search_planned(
        tt["row_pk"][order], tt["row_pop"][order], skey, order, tt["t_pk"],
        tt["t_pops"], tt["t_slot"], tt["pend"], items,
    )
    j_order, j_skey, j_nxt = jax_plan(jnp.asarray(key), guard)
    np.testing.assert_array_equal(order.numpy(), np.asarray(j_order))
    np.testing.assert_array_equal(skey.numpy(), np.asarray(j_skey))
    jrows = jnp.asarray(row_pk)[j_order]
    jpops = jnp.asarray(row_pop)[j_order]
    ref = jax_planned(
        jrows, jpops, j_skey, j_nxt, j_order, jnp.asarray(t_pk),
        jnp.asarray(t_pops), jnp.asarray(t_slot), jnp.asarray(pending_now),
        guard_group=guard, interpret=True,
    )
    _assert_contract(ref, got)
    _assert_contract(
        _search_tiles(*map(jnp.asarray, (
            row_pk, row_pop, row_group, t_pk, t_pops, t_slot, pending_now
        ))),
        got,
    )


def _items_reference(skey: np.ndarray, r: int) -> list[int]:
    r"""Item starts by a loop: a new item where the key changes and after
    every ``r`` rows of one key."""
    starts, run = [], 0
    for s in range(len(skey)):
        run = run + 1 if s and skey[s] == skey[s - 1] else 0
        if run % r == 0:
            starts.append(s)
    return starts


@pytest.mark.parametrize(
    "runs",
    [
        [1],
        [64],
        [65],
        [200],  # one group past R: split at 64, 128, 192
        [3, 64, 1, 129, 7],
        [1] * 50 + [130],
        [8192],  # the fit's batch on one group
    ],
)
def test_plan_item_table_matches_reference(runs) -> None:
    r"""The plan's item table: segment boundaries, splits every ITEM_ROWS
    rows of one group, the count in the table's last entry, and M past
    the count."""
    rng = np.random.default_rng(len(runs))
    groups = np.sort(rng.choice(1 << 20, size=len(runs), replace=False))
    key = np.repeat(groups, runs).astype(np.int32)
    rng.shuffle(key)
    order, skey, items = ts.sorted_search_plan(torch.from_numpy(key))
    m = len(key)
    assert items.dtype == torch.int32 and items.shape == (m + 1,)
    ref = _items_reference(skey.numpy(), ts.ITEM_ROWS)
    n = int(items[m])
    assert n == len(ref) == sum(-(-k // ts.ITEM_ROWS) for k in runs)
    np.testing.assert_array_equal(items[:n].numpy(), ref)
    assert (items[n:m] == m).all()
    bounds = ref + [m]
    for s0, s1 in zip(bounds[:-1], bounds[1:]):
        assert 1 <= s1 - s0 <= ts.ITEM_ROWS
        assert (skey[s0:s1] == skey[s0]).all()
    np.testing.assert_array_equal(skey.numpy(), key[order.numpy()])


def test_failed_build_raises(monkeypatch, tmp_path) -> None:
    r"""A failed ``nvcc`` build raises (no fallback, no library left)."""
    import subprocess

    monkeypatch.setattr(_build, "_BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "_find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(
        _build.subprocess, "run",
        lambda *a, **k: subprocess.CompletedProcess(a, 2, "", "error: boom"),
    )
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.load_kernel_library("tile_search.cu")
    assert list(tmp_path.iterdir()) == []


def test_missing_nvcc_raises(monkeypatch) -> None:
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._find_nvcc()
