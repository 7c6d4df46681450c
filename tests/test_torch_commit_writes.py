r"""The insert round's pool and tile writes (``ops/commit_writes.py``)
against JAX.

The writes are rebuilt here in JAX as ``bblean_tpu/engine/batch.py`` writes
them: ``:572-579`` (each joint creation's sums spread to its rows),
``:660-684`` (step 7: the created clusters' majority votes, packed into
their tile cells with their popcounts and slots) and ``:686-736`` (step 8:
the segment sums of the committed rows, the promotions, the adds and the
pooled creations, the pool refs and the cluster counts, every scatter in
``mode="drop"``), and run in the port as the batch engine runs them:
``commit_writes_plain`` (what the wrapper runs for CPU tensors).  Every
table must equal JAX's exactly.  Inputs are
``chip_smoke.commit_writes_case``'s at 64-256 rows of 64 or 100 bits:
promotions and adders, pooled creations with and without a cohesive
joint, the vote's edge and its ``n <= 1`` rule, writes past capacity, the
guard row, segments longer than the kernel's chunk of 32 sorted rows, and
rows flagged ``row_single`` beside unflagged ones.  The flag itself is
held to its rule on every producer of the step's rows, and the packed row
of a flagged row to the vote the plain version writes for it.  The CUDA
kernel itself runs only on a card (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase 2g), where it is held to the plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from bblean_tpu.ops.isim import majority_centroid_from_sums as jax_vote
from bblean_tpu.ops.packing import pack_fingerprints_device as jax_pack
from bblean_tpu.ops.packing import unpack_fingerprints_device as jax_unpack
from bblean_tpu_torch.engine import batch as tb
from bblean_tpu_torch.ops import commit_writes as cw
from bblean_tpu_torch.ops.isim import majority_centroid_from_sums
from bblean_tpu_torch.ops.packing import pack_fingerprints_device, unpack_fingerprints_device

torch.set_num_threads(2)

SEED = 20261019


def _jax_writes(c: dict) -> tuple:
    r"""The JAX lines on ``commit_writes_case``'s arrays: the six tables
    after the round's writes (numpy)."""
    a = {k: jnp.asarray(v) for k, v in c.items()}
    m, f = c["row_ls"].shape
    g_cap, fc, _f8 = c["t_pk"].shape
    p_cap = c["ls"].shape[0]
    c_cap = c["n"].shape[0]
    # :572-579 (jorder, jgrp: the rows sorted by their cohesion segment)
    jorder = jnp.argsort(a["jseg"], stable=True)
    jgrp = a["jseg"][jorder]
    gj_full_ls = jnp.zeros_like(a["row_ls"]).at[jorder].set(a["gj_ls"][jgrp], unique_indices=True)
    pool_created_ls = jnp.where(a["join_ok"][:, None], gj_full_ls, a["row_ls"])
    # The promoted candidates' old bits, from the tiles before the round
    # (``_cluster_ls_of`` of a singleton)
    cand_ls_s = jax_unpack(a["t_pk"][a["group"][a["best_s"]], a["pos"][a["best_s"]]], f).astype(jnp.int32)
    # :660-684
    tgt_group, tgt_pos = a["cell"] // fc, a["cell"] % fc
    created_ls = jnp.where((a["join_ok"] & a["fits"])[:, None], gj_full_ls, a["row_ls"])
    c_cent = jax_vote(created_ls, jnp.maximum(a["created_n"], 1))
    c_packed = jax_pack(c_cent)
    ts_g = jnp.where(a["create_commit"], tgt_group, g_cap)
    t_pk = a["t_pk"].at[ts_g, tgt_pos].set(c_packed, mode="drop", unique_indices=True)
    t_pops = a["t_pops"].at[ts_g, tgt_pos].set(
        jnp.sum(c_cent.astype(jnp.int32), axis=-1), mode="drop", unique_indices=True
    )
    t_slot = a["t_slot"].at[ts_g, tgt_pos].set(a["new_slot"], mode="drop", unique_indices=True)
    # :686-723
    seg_add_ls = jax.ops.segment_sum(
        jnp.where(a["committed"][:, None], a["row_ls"][a["aorder"]], 0), a["agrp"], num_segments=m,
    )[a["agrp"]]
    pool = a["ls"].at[jnp.where(a["promo"], a["ref_promo"], p_cap)].set(
        cand_ls_s + seg_add_ls, mode="drop", unique_indices=True
    )
    pool = pool.at[jnp.where(a["adder"], a["cand_ref"], p_cap)].add(
        seg_add_ls, mode="drop", unique_indices=True
    )
    pool = pool.at[jnp.where(a["create_pool"], a["ref_create"], p_cap)].set(
        pool_created_ls, mode="drop", unique_indices=True
    )
    # :718-723 (best_s is the sorted best) and :727-736
    ls_ref = a["ls_ref"].at[jnp.where(a["promo"], a["best_s"], c_cap)].set(
        a["ref_promo"], mode="drop", unique_indices=True
    )
    ls_ref = ls_ref.at[jnp.where(a["create_pool"], a["new_slot"], c_cap)].set(
        a["ref_create"], mode="drop", unique_indices=True
    )
    seg_add_n = jax.ops.segment_sum(
        jnp.where(a["committed"], a["row_n"][a["aorder"]], 0), a["agrp"], num_segments=m,
    )[a["agrp"]]
    n = a["n"].at[jnp.where(a["seg_any"], a["best_s"], c_cap)].add(
        seg_add_n, mode="drop", unique_indices=True
    )
    n = n.at[jnp.where(a["create_commit"], a["new_slot"], c_cap)].add(
        a["pool_created_n"], mode="drop", unique_indices=True
    )
    return tuple(np.asarray(t) for t in (pool, t_pk, t_pops, t_slot, ls_ref, n))


def _check(case: dict) -> tuple:
    r"""The port's plain writes on fresh tables equal JAX's; returns the
    port's tables (numpy)."""
    args = chip_smoke.writes_args(case, "cpu")
    assert cw.commit_writes(*args) is None
    got = tuple(t.numpy() for t in args[: len(chip_smoke.WRITES_TABLES)])
    for name, g, w in zip(chip_smoke.WRITES_TABLES, got, _jax_writes(case)):
        np.testing.assert_array_equal(g, w, err_msg=name)
    return got


@pytest.mark.parametrize("m,f", [(256, 64), (64, 64), (128, 100)])
@pytest.mark.parametrize("layout", chip_smoke.WRITES_LAYOUTS)
def test_writes_match_jax(layout, m, f) -> None:
    rng = np.random.default_rng(SEED + chip_smoke.WRITES_LAYOUTS.index(layout) + m + f)
    case = chip_smoke.commit_writes_case(rng, m, f, layout)
    got = _check(case)
    promo, adder = case["promo"], case["adder"]
    if layout == "singletons":
        assert promo.sum() > adder.sum() > 0
    elif layout == "one segment":
        assert promo.sum() + adder.sum() == 1
    else:
        assert promo.any() and adder.any()
    # The guard row, the guard group's last cell and the guard slot keep
    # their values
    np.testing.assert_array_equal(got[0][-1], case["ls"][-1])
    np.testing.assert_array_equal(got[1][-1, -1], case["t_pk"][-1, -1])
    assert got[4][-1] == case["ls_ref"][-1] and got[5][-1] == case["n"][-1]
    # The counts moved where the round adds: the writers' and the
    # committed creations' slots
    assert (got[5] != case["n"]).any() and (got[4] != case["ls_ref"]).any()
    if layout == "mixed":
        chip_smoke._writes_mixed_segment(case, "mixed")


def test_case_covers_the_edges() -> None:
    r""""edges" holds what it claims: sums at the vote's edge, counts of 0
    and 1 with sums past 1, writes past every table's capacity (which
    drop, the slots of three pooled and three committed creations among
    them), pooled creations with and without a cohesive joint, and a merge
    segment longer than the kernel's chunk of 32 sorted rows."""
    rng = np.random.default_rng(SEED + 1)
    c = chip_smoke.commit_writes_case(rng, 256, 64, "edges")
    got = _check(c)
    p_cap = c["ls"].shape[0]
    n_cells = c["t_pk"].shape[0] * c["t_pk"].shape[1]
    own = c["create_commit"] & ~(c["join_ok"] & c["fits"])
    n = np.maximum(c["created_n"], 1)
    assert (own[:, None] & (2 * c["row_ls"] == n[:, None]) & (n[:, None] > 1)).sum() > 20
    assert (own & (c["created_n"] == 0)).any() and (own[:, None] & (n[:, None] <= 1) & (c["row_ls"] > 1)).any()
    for mask, ref, cap in ((c["promo"], c["ref_promo"], p_cap), (c["adder"], c["cand_ref"], p_cap),
                           (c["create_pool"], c["ref_create"], p_cap),
                           (c["create_commit"], c["cell"], n_cells)):
        assert (mask & (ref >= cap)).sum() == 3
    c_cap = c["n"].shape[0]
    for mask in (c["create_pool"], c["create_commit"]):
        assert (mask & (c["new_slot"] >= c_cap)).sum() >= 3
    assert (c["create_pool"] & c["join_ok"]).any() and (c["create_pool"] & ~c["join_ok"]).any()
    _keys, sizes = np.unique(c["agrp"][c["committed"]], return_counts=True)
    assert sizes.max() > 32
    # Rows outside every mask and write past capacity leave the pool as it was
    written = np.zeros(p_cap, bool)
    for mask, ref in ((c["promo"], c["ref_promo"]), (c["adder"], c["cand_ref"]),
                      (c["create_pool"], c["ref_create"])):
        written[ref[mask & (ref < p_cap)]] = True
    np.testing.assert_array_equal(got[0][~written], c["ls"][~written])


def test_writes_bound_counts_the_rows() -> None:
    r"""The bound charges the committed rows (a flagged row its packed
    bytes), the joint and own sums read (a flagged own cell at a count <= 1
    its packed bytes), the pool rows written (adders twice), the promoted
    cells, the tile cells, the refs and the counts; a write past capacity
    moves nothing.  The int32 charge reads every row as sums and leaves
    out the refs and counts."""
    rng = np.random.default_rng(SEED + 2)
    c = chip_smoke.commit_writes_case(rng, 256, 2048, "edges")
    args = chip_smoke.writes_args(c, "cpu")
    r = chip_smoke._writes_reads(args)
    assert r["promo"] == int(c["promo"].sum()) - 3 and r["adder"] == int(c["adder"].sum()) - 3
    assert r["pooled"] == int(c["create_pool"].sum()) - 3 and r["tiles"] == int(c["create_commit"].sum()) - 3
    assert 0 < r["committed_packed"] < r["committed"] and 0 < r["own_packed"] < r["own"]
    slot_ok = c["new_slot"] < c["n"].shape[0]
    assert r["refs"] == int(c["promo"].sum() + (c["create_pool"] & slot_ok).sum())
    assert r["counts"] == int(c["seg_any"].sum() + (c["create_commit"] & slot_ok).sum())
    row, f8 = 2048 * 4, 256
    common = (r["promo"] + 2 * r["adder"] + r["pooled"]) * row + r["promo"] * f8 + r["tiles"] * (f8 + 8)
    want = (
        (r["committed"] - r["committed_packed"] + r["joint"] + r["own"] - r["own_packed"]) * row
        + (r["committed_packed"] + r["own_packed"]) * f8 + common + r["refs"] * 4 + r["counts"] * 8
        + 256 * (8 + 44 + 9)
    )
    want_int32 = (r["committed"] + r["joint"] + r["own"]) * row + common + 256 * (8 + 40 + 7)
    b = chip_smoke._writes_bound(args)
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx(want / chip_smoke.HBM_BYTES_PER_S * 1e3)
    assert b["bound_int32_ms"] == pytest.approx(want_int32 / chip_smoke.HBM_BYTES_PER_S * 1e3)
    assert b["bound_ms"] < b["bound_int32_ms"]


def test_library_yardstick_is_the_adders_part() -> None:
    r"""``index_add_`` of the adders' committed rows gives the adders' pool
    rows of the plain version's writes (on a case without promotions or
    creations that write)."""
    rng = np.random.default_rng(SEED + 3)
    c = chip_smoke.commit_writes_case(rng, 128, 64, "t=0.3 runs")
    c["promo"][:] = False
    c["create_pool"][:] = False
    c["create_commit"][:] = False
    args = chip_smoke.writes_args(c, "cpu")
    ls = args[0].clone()
    chip_smoke._writes_library(args)(ls)
    cw.commit_writes_plain(*args)
    assert torch.equal(ls, args[0])


def test_insert_round_writes_through_the_wrapper(monkeypatch) -> None:
    r"""Each insert round makes one call of ``commit_writes`` and of
    ``elect_leaders`` (the diameter criterion elects every round), and no
    (M, F) plane is spread from the cohesion sums: the writes read
    ``gj_ls`` through each row's segment (``jseg``)."""
    from bblean_tpu_torch import BatchTree
    from bblean_tpu_torch.fingerprints import make_fake_fingerprints

    calls = {"round": 0, "writes": 0, "elect": 0}

    def counted(name, fn):
        def call(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)

        return call

    def writes(*args):
        calls["writes"] += 1
        a = dict(zip(chip_smoke.WRITES_ARGS, args))
        m = a["row_ls"].shape[0]
        assert a["gj_ls"].shape == a["row_ls"].shape and a["jseg"].shape == (m,)
        assert a["ls"] is not a["row_ls"] and a["t_pk"].dim() == 3
        return cw.commit_writes(*args)

    monkeypatch.setattr(tb, "_insert_round", counted("round", tb._insert_round))
    monkeypatch.setattr(tb, "elect_leaders", counted("elect", tb.elect_leaders))
    monkeypatch.setattr(tb, "commit_writes", writes)
    fps = make_fake_fingerprints(300, 256, seed=5)
    tree = BatchTree(256, threshold=0.3, batch_size=64, device="cpu")
    tree.fit_packed(fps, range(300))
    assert calls["round"] > 0
    assert calls["writes"] == calls["elect"] == calls["round"]


def _flag_rule(rows) -> torch.Tensor:
    r"""A row is one fingerprint: a count of 1 and sums that are the bits
    of its packed row."""
    row_ls, row_n, _cent, row_pk, _pop, _single = rows
    bits = unpack_fingerprints_device(row_pk, row_ls.shape[1]).to(torch.int32)
    return (row_n == 1) & (row_ls == bits).all(-1)


def _assert_flag(rows, want: torch.Tensor) -> None:
    single = rows[5]
    assert single.dtype == torch.bool and single.shape == rows[1].shape
    assert torch.equal(single, want)
    assert torch.equal(single, _flag_rule(rows))


@pytest.mark.parametrize("f", [64, 100, 2048])
def test_row_flag_of_every_producer(f) -> None:
    r"""``row_single`` on each producer of the step's rows: the fit's
    slices (padding rows unflagged), the packed rows of ``_prep_fp_rows``,
    and the buffer rows of ``_prep_buffer_rows`` at counts 0, 1 and 2 or
    more, with rows of count 1 whose sums hold a 2 or a -1 (unflagged)."""
    rng = np.random.default_rng(SEED + 5 + f)
    f8 = (f + 7) // 8
    fps = np.packbits(rng.random((40, f)) < 0.2, axis=1)
    dev_fps = torch.from_numpy(fps)
    rows = tb._slice_prep_fp_rows_impl(dev_fps, 8, 13, 16, f)
    _assert_flag(rows, torch.arange(16) < 13)
    valid = torch.from_numpy(rng.random(16) < 0.7)
    rows = tb._prep_fp_rows(dev_fps[:16], valid, f)
    _assert_flag(rows, valid)

    row_n = np.array([0, 1, 1, 1, 1, 2, 3, 4, 1, 0], np.int32)
    row_ls = rng.binomial(np.maximum(row_n, 1)[:, None], 0.3, (10, f)).astype(np.int32)
    row_ls[0] = 0  # a padding row
    row_ls[2, 5] = 2
    row_ls[3, f - 1] = -1
    row_ls[5] = np.clip(row_ls[5], 0, 1)  # a count of 2 with 0/1 sums
    row_ls[9, 3] = 1
    rows = tb._prep_buffer_rows(torch.from_numpy(row_ls), torch.from_numpy(row_n))
    want = torch.tensor([False, True, False, False, True, False, False, False, True, False])
    _assert_flag(rows, want)
    assert rows[3].shape == (10, f8)


def test_row_flag_of_the_merge(monkeypatch) -> None:
    r"""The sharded merge inserts another shard's clusters through
    ``_prep_buffer_rows`` (a gate margin of 1 sends every received group
    to the row-level insert): its rows reach the step flagged by the rule,
    the singletons flagged and the clusters of several members not."""
    from bblean_tpu_torch.fingerprints import make_fake_fingerprints
    from bblean_tpu_torch.parallel import get_mesh, sharded
    from bblean_tpu_torch.parallel import sharded_fit

    seen = []

    def prep(row_ls, row_n):
        rows = tb._prep_buffer_rows(row_ls, row_n)
        seen.append(rows)
        return rows

    monkeypatch.setattr(sharded, "_prep_buffer_rows", prep)
    fps = make_fake_fingerprints(400, seed=11)
    sharded_fit(fps, get_mesh(devices=["cpu"] * 2), input_is_packed=True, threshold=0.3,
                batch_size=64, merge_gate_margin=1.0)
    assert seen
    for rows in seen:
        assert torch.equal(rows[5], _flag_rule(rows))
    n = torch.cat([r[1] for r in seen])
    single = torch.cat([r[5] for r in seen])
    assert single.any() and (n >= 2).any() and not single[n >= 2].any()


@pytest.mark.parametrize("layout", ["t=0.3 runs", "edges", "mixed"])
def test_packed_row_is_the_own_creation_vote(layout) -> None:
    r"""Where a creation votes over its own sums at ``created_n = row_n``
    (off the joint path), a flagged row's packed row is the cell the plain
    version writes, and its popcount the cell's count: what the kernel
    copies in place of the vote."""
    rng = np.random.default_rng(SEED + 6)
    c = chip_smoke.commit_writes_case(rng, 256, 100, layout)
    c["join_ok"][:] = False
    c["created_n"] = c["row_n"].copy()
    args = chip_smoke.writes_args(c, "cpu")
    cw.commit_writes_plain(*args)
    a = dict(zip(chip_smoke.WRITES_ARGS, args))
    flagged = a["create_commit"] & a["row_single"] & (a["cell"] < a["t_pops"].numel())
    assert int(flagged.sum()) > 5
    cells = a["cell"][flagged].long()
    t_pk, t_pops = a["t_pk"].view(-1, a["t_pk"].shape[2]), a["t_pops"].view(-1)
    assert torch.equal(t_pk[cells], a["row_pk"][flagged])
    pops = unpack_fingerprints_device(a["row_pk"][flagged], 100).sum(-1, dtype=torch.int32)
    assert torch.equal(t_pops[cells], pops)
    # And on every producer: the vote at the row's count is its packed row
    for rows in (
        tb._slice_prep_fp_rows_impl(torch.from_numpy(np.packbits(rng.random((30, 100)) < 0.3, axis=1)),
                                    0, 20, 30, 100),
        tb._prep_buffer_rows(torch.from_numpy(c["row_ls"]), torch.from_numpy(c["row_n"])),
    ):
        single = rows[5]
        vote = majority_centroid_from_sums(rows[0][single], rows[1][single].clamp_min(1))
        assert torch.equal(pack_fingerprints_device(vote), rows[3][single])
        assert torch.equal(vote.sum(-1, dtype=torch.int32), rows[4][single])
