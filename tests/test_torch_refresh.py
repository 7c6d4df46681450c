r"""The batch step's refresh (``ops/refresh.py``) against JAX.

JAX's ``bblean_tpu/engine/batch.py:891`` ``_refresh_touched`` is run on a
state holding the case's tables, and the port's plain version
(``refresh_touched_plain``, what the wrapper runs for CPU tensors) on the
same tables: ``g_ls``, ``g_n``, ``t_pk``, ``t_pops``, ``g_cent`` and
``g_pops`` must equal JAX's exactly.  Inputs are
``chip_smoke.refresh_case``'s at 64-128 rows of 16 or 2048 bits, tiles of
256 and 512 cells: one hot group taking most rows, many groups of one row,
pool clusters and singletons mixed, creations sent to overflow groups, no
committed row, the guard slot pointing at live data, the vote's edges;
and the refresh's inputs captured at steps of a real CPU fit.  The batch
step hands the wrapper its packed rows, their flags and the step's sort
plan, a permutation of its rows.  The CUDA kernel itself runs only on a
card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 2h), where it
is held to the plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from bblean_tpu.engine import batch as jb
from bblean_tpu_torch import BatchTree
from bblean_tpu_torch.engine import batch as tb
from bblean_tpu_torch.fingerprints import make_fake_fingerprints
from bblean_tpu_torch.ops import refresh as rf

torch.set_num_threads(2)

SEED = 12620509540149709235
TABLES = chip_smoke.REFRESH_TABLES


def _jax_refresh(c: dict) -> tuple:
    r"""JAX's refresh of the case's tables, as numpy (the six it updates)."""
    g_cap, fc, _f8 = c["t_pk"].shape
    state = jb.BatchState(
        ls=jnp.asarray(c["ls"]), num_ls=jnp.int32(0), ls_ref=jnp.asarray(c["ls_ref"]),
        n=jnp.asarray(c["n"]), group=jnp.asarray(c["group"]), pos=jnp.asarray(c["pos"]),
        num=jnp.int32(0), t_pk=jnp.asarray(c["t_pk"]), t_pops=jnp.asarray(c["t_pops"]),
        t_slot=jnp.full((g_cap, fc), -1, jnp.int32), g_ls=jnp.asarray(c["g_ls"]),
        g_n=jnp.asarray(c["g_n"]), g_cent=jnp.asarray(c["g_cent"]),
        g_pops=jnp.asarray(c["g_pops"]), g_count=jnp.zeros((g_cap,), jnp.int32),
        g_num=jnp.int32(g_cap - 1),
    )
    out = jb._refresh_touched(
        state, jnp.asarray(c["assigned"]), jnp.asarray(c["row_ls"]), jnp.asarray(c["row_n"])
    )
    return tuple(np.asarray(getattr(out, k)) for k in TABLES)


def _check(case: dict) -> tuple:
    r"""The port's plain refresh on fresh tables equals JAX's; returns the
    port's tables (numpy)."""
    args = chip_smoke.refresh_args(case, "cpu")
    assert rf.refresh_touched(*args) is None
    got = tuple(t.numpy() for t in args[: len(TABLES)])
    for name, g, w in zip(TABLES, got, _jax_refresh(case)):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    return got


@pytest.mark.parametrize("m,f,fc", [(128, 2048, 256), (96, 16, 512)])
@pytest.mark.parametrize("layout", chip_smoke.REFRESH_LAYOUTS)
def test_refresh_matches_jax(layout, m, f, fc) -> None:
    rng = np.random.default_rng(SEED + chip_smoke.REFRESH_LAYOUTS.index(layout) + m + f)
    case = chip_smoke.refresh_case(rng, m, f, fc, layout)
    got = _check(case)
    # The guard group's rows keep their values
    for name, g in zip(TABLES, got):
        np.testing.assert_array_equal(g[-1], case[name][-1], err_msg=name)
    r = chip_smoke._refresh_reads(chip_smoke.refresh_args(case, "cpu"))
    if layout == "none":
        assert r["committed"] == 0
        for name, g in zip(TABLES, got):
            np.testing.assert_array_equal(g, case[name], err_msg=name)
        return
    assert r["pooled"] > 0 and r["singletons"] > 0
    assert not np.array_equal(got[0], case["g_ls"]) and not np.array_equal(got[2], case["t_pk"])
    if layout == "one hot group":
        groups = case["group"][case["assigned"][case["assigned"] >= 0]]
        assert (groups == 0).mean() > 0.75
    if layout == "singleton groups":
        assert r["groups"] == r["committed"]


def test_case_covers_its_layouts() -> None:
    r"""The layouts hold what they claim: overflow rows committed to a
    group other than the one the step's plan routes them to, in runs that
    the plan's order breaks; the guard slot pointing at a live pool row;
    the vote's edges committed to (pool clusters of counts 0 and 1 with
    sums past 1, singletons of counts 2 and 3, groups at f32's rounding);
    flagged and unflagged rows."""
    rng = np.random.default_rng(SEED + 11)
    c = chip_smoke.refresh_case(rng, 128, 64, 256, "overflow")
    ok = c["assigned"] >= 0
    committed_group = c["group"][c["assigned"]]
    routed_runs = committed_group[c["order"]][ok[c["order"]]]
    assert (np.diff(routed_runs) < 0).any()  # an overflow group breaks a run
    assert np.array_equal(np.sort(c["order"]), np.arange(128))
    g = chip_smoke.refresh_case(np.random.default_rng(SEED + 12), 128, 64, 256, "guard")
    assert g["ls_ref"][-1] >= 0 and g["n"][-1] > 0
    e = chip_smoke.refresh_case(np.random.default_rng(SEED + 13), 128, 64, 256, "edges")
    slots = e["assigned"][e["assigned"] >= 0]
    n, ref = e["n"][slots], e["ls_ref"][slots]
    assert ((ref >= 0) & (n <= 1) & (e["ls"][np.maximum(ref, 0)].max(1) > 1)).any()
    assert ((ref < 0) & (n >= 2)).any()
    touched = np.unique(e["group"][slots])
    assert (e["g_n"][touched] > 1 << 25).any() and (e["g_n"][touched] <= 1).any()
    assert e["row_single"].any() and (~e["row_single"] & (e["row_n"] == 1)).any()


def test_refresh_bound_counts_the_work() -> None:
    r"""The bound charges the committed rows (a flagged row its packed
    bytes), each touched group's sums three times, each touched cluster's
    pool row or cell, the cells and centroids written and the (M,) inputs."""
    c = chip_smoke.refresh_case(np.random.default_rng(SEED + 14), 128, 2048, 256, "edges")
    args = chip_smoke.refresh_args(c, "cpu")
    r = chip_smoke._refresh_reads(args)
    assert 0 < r["committed_packed"] < r["committed"]
    slots = np.unique(c["assigned"][c["assigned"] >= 0])
    assert r["pooled"] + r["singletons"] == len(slots)
    assert r["groups"] == len(np.unique(c["group"][slots]))
    f, f8 = 2048, 256
    want = (
        (r["committed"] - r["committed_packed"]) * 4 * f + r["committed_packed"] * f8
        + r["groups"] * (12 * f + 8 + f + 4) + r["pooled"] * (4 * f + 8)
        + r["singletons"] * (f8 + 8) + len(slots) * (f8 + 12) + 128 * 17
    )
    b = chip_smoke._refresh_bound(args)
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx(want / chip_smoke.HBM_BYTES_PER_S * 1e3)


@pytest.fixture(scope="module")
def fit_steps():
    r"""The refresh's inputs (numpy, tables before the refresh) at three
    steps of a CPU fit of 1,500 rows at t = 0.3 (batch 64), and the row
    orders every step handed the wrapper."""
    fps = make_fake_fingerprints(1500, 2048, seed=SEED)
    seen, orders = [], []
    original = tb._refresh_touched

    def record(state, assigned, row_ls, row_n, row_pk, row_single, order):
        orders.append((order.numpy().copy(), assigned.shape[0]))
        if len(orders) in (3, 12, 20):
            seen.append({
                **{k: getattr(state, k).numpy().copy() for k in TABLES + ("ls", "ls_ref", "n", "group", "pos")},
                "assigned": assigned.numpy().copy(), "row_ls": row_ls.numpy().copy(),
                "row_n": row_n.numpy().copy(), "row_pk": row_pk.numpy().copy(),
                "row_single": row_single.numpy().copy(), "order": order.numpy().copy(),
            })
        return original(state, assigned, row_ls, row_n, row_pk, row_single, order)

    tb._refresh_touched = record
    try:
        tree = BatchTree(2048, threshold=0.3, batch_size=64, device="cpu")
        tree.fit_packed(fps, range(1500))
    finally:
        tb._refresh_touched = original
    return seen, orders


@pytest.mark.parametrize("step", [0, 1, 2])
def test_refresh_of_a_fit_step_matches_jax(fit_steps, step) -> None:
    seen, _orders = fit_steps
    case = seen[step]
    assert (case["assigned"] >= 0).any()
    got = _check(case)
    assert not np.array_equal(got[0], case["g_ls"])


def test_step_hands_the_refresh_its_plan(fit_steps) -> None:
    r"""Every step's refresh gets a permutation of its rows as its order
    (the kernel adds each row once, in that order)."""
    _seen, orders = fit_steps
    assert len(orders) > 20
    for order, m in orders:
        assert order.dtype == np.int64 and np.array_equal(np.sort(order), np.arange(m))


@pytest.mark.parametrize("m", [1, 2, 3, 64, 8192, 8193])
def test_scratch_holds_two_sets_of_twice_the_rows(m) -> None:
    r"""The scratch: two hash sets of a power of two of at least 2M words,
    two lists of M and three counters, all zero, made once per (device,
    stream, rows)."""
    dev = torch.device("cpu")
    try:
        buf, h = rf._scratch_for(dev, 12345, m)
        assert h >= 2 * m and h & (h - 1) == 0 and h < 4 * m + 2
        assert buf.shape == (2 * h + 2 * m + 3,) and buf.dtype == torch.int32
        assert not buf.any()
        assert rf._scratch_for(dev, 12345, m)[0] is buf
    finally:
        rf._scratch.pop((dev.index, 12345, m), None)
