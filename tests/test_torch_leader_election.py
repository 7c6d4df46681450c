r"""The insert round's leader election (``ops/leader_election.py``) against
JAX.

The election is rebuilt here in JAX as ``bblean_tpu/engine/batch.py:504-540``
writes it (the (M, M) planes, ``jnp.any``, ``jnp.argmax``, ``jnp.max``; in
narrow rounds the int8 Gram of the rejected rows by ``lax.dot_general``)
and run in the port as the batch engine runs it: ``elect_leaders_plain``
(what the wrapper runs for CPU tensors) from the packed rows with the
step's sort plan (a wide round) and with a wider step's plan through the
selection of its rows (a narrow round), and with an all-pairs row Gram in
place of the packed rows (JAX's wide rounds' input), with and without the
plan.
``leads`` and ``lead_of`` must equal JAX's exactly and ``best_lead_sim``
bit for bit.  Inputs are ``chip_smoke.election_case``'s at 64-256 rows of
64 or 100 bits: every row on one group, groups as a mid-fit round's, a
fit's mid-fit wide round, rows that tie (duplicates), rows struck twice,
no rejected row.  A numpy reference of the kernel's contract (leads on
every row, the best leader of the rejected rows that do not lead) and one
wide round of the engine against JAX's round complete it, with a check
that every plan a round passes lists its rejected rows by (group, row) as
the kernel reads them.  The CUDA
kernel itself runs only on a card (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase 2f), where it is held to the plain version on
the rows its contract covers.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import chip_smoke
from bblean_tpu_torch.engine import batch as tb
from bblean_tpu_torch.ops import leader_election as le
from bblean_tpu_torch.ops.packing import unpack_fingerprints_device

torch.set_num_threads(2)

SEED = 20261018
_NEG = -2.0
# (sims, plan) of ``chip_smoke.election_args``: "wide" and "wide without
# plan" take the row Gram (JAX's wide rounds' input), "wide packed rows"
# and "narrow" are the port's wide and narrow rounds' calls
MODES = {
    "wide": (True, "wide"), "wide without plan": (True, None), "narrow": (False, "narrow"),
    "wide packed rows": (False, "wide"),
}


def _jax_election(rejected, force_lead, row_group, threshold, row_cent, row_pop, row_sims):
    r"""``bblean_tpu/engine/batch.py:504-540`` on numpy inputs (``row_sims``
    None: the narrow rounds' in-round Gram)."""
    rejected, force_lead, row_group = map(jnp.asarray, (rejected, force_lead, row_group))
    m = rejected.shape[0]
    row_idx = jnp.arange(m, dtype=jnp.int32)
    if row_sims is not None:
        rsims = jnp.asarray(row_sims)
    else:
        rcent = jnp.where(rejected[:, None], jnp.asarray(row_cent), 0)
        rsims = lax.dot_general(
            rcent, rcent, (((1,), (1,)), ((), ())), preferred_element_type=jnp.int32,
        ).astype(jnp.float32)
        rpop = jnp.where(rejected, jnp.asarray(row_pop), 0)
        runion = rpop[:, None] + rpop[None, :] - rsims
        rsims = rsims / jnp.maximum(runion, 1.0)
    same_group = row_group[:, None] == row_group[None, :]
    lower = row_idx[None, :] < row_idx[:, None]
    sim_to_lower = jnp.where(lower & rejected[None, :] & same_group, rsims, _NEG)
    leads = rejected & (force_lead | ~jnp.any(sim_to_lower >= threshold, axis=1))
    sim_to_leader = jnp.where(leads[None, :], sim_to_lower, _NEG)
    lead_of = jnp.argmax(sim_to_leader, axis=1).astype(jnp.int32)
    best_lead_sim = jnp.max(sim_to_leader, axis=1)
    return tuple(np.asarray(a) for a in (leads, lead_of, best_lead_sim))


def _check(case, mode: str, threshold: float = chip_smoke.ELECTION_THRESHOLD):
    r"""The port's plain election on ``case`` in ``mode`` equals JAX's;
    returns the port's outputs as numpy."""
    sims, plan = MODES[mode]
    args = list(chip_smoke.election_args(case, "cpu", plan, sims))
    args[3] = torch.tensor(threshold, dtype=torch.float32)
    got = le.elect_leaders(*args)
    rejected, force, group, _valid, row_pk, row_pop = case
    cent = unpack_fingerprints_device(torch.from_numpy(row_pk)).to(torch.int8).numpy()
    sims = None if args[4] is None else args[4].numpy()
    want = _jax_election(rejected, force, group, np.float32(threshold), cent, row_pop, sims)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    np.testing.assert_array_equal(got[2].numpy().view(np.int32), want[2].view(np.int32))
    return tuple(a.numpy() for a in got)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("layout", chip_smoke.ELECTION_LAYOUTS)
def test_election_matches_jax(layout, mode) -> None:
    rng = np.random.default_rng(SEED + chip_smoke.ELECTION_LAYOUTS.index(layout))
    case = chip_smoke.election_case(rng, 192, 64, layout)
    leads, lead_of, best = _check(case, mode)
    rejected, force = case[0], case[1]
    if layout == "none rejected":
        assert not leads.any() and (lead_of == 0).all() and (best == _NEG).all()
    elif layout == "force lead":
        assert leads[force].all() and force.sum() >= 10
    else:
        # Both outcomes: leaders and rejected rows that join
        assert 0 < leads.sum() < rejected.sum()


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("m,f", [(256, 100), (64, 64), (1, 64)])
def test_election_matches_jax_at_sizes(m, f, mode) -> None:
    r"""Mid-fit-like groups at other sizes: 100 bits (a byte tail in the
    packed rows), a single row."""
    rng = np.random.default_rng(SEED + m + f)
    _check(chip_smoke.election_case(rng, m, f, "t=0.3 groups"), mode)


@pytest.mark.parametrize("mode", list(MODES))
def test_ties_take_the_first_leader(mode) -> None:
    r"""Duplicate rows tie at sim 1.0.  With every rejected row struck
    twice (every one leads), a row's leader is the lowest of its tied
    duplicates below it; and a threshold equal to a sim counts (>=)."""
    rng = np.random.default_rng(SEED + 3)
    case = chip_smoke.election_case(rng, 128, 64, "ties")
    _check(case, mode, threshold=1.0)
    case = (case[0], case[0].copy(), *case[2:])
    leads, lead_of, best = _check(case, mode)
    rejected, group, row_pk = case[0], case[2], case[4]
    assert (leads == rejected).all()
    tied = 0
    for j in np.flatnonzero(best == 1.0):
        same = (group == group[j]) & leads & (np.arange(128) < j) & (row_pk == row_pk[j]).all(1)
        assert lead_of[j] == np.flatnonzero(same)[0]
        tied += same.sum() > 1
    assert tied > 10


@pytest.mark.parametrize("mode", list(MODES))
def test_one_group_holds_every_row(mode) -> None:
    r"""A fit's first batch: every row on group 0 and rejected; the first
    row leads, no row below it, so its best is ``_NEG`` and its leader 0."""
    rng = np.random.default_rng(SEED + 4)
    case = chip_smoke.election_case(rng, 256, 64, "one group")
    leads, lead_of, best = _check(case, mode)
    assert leads[0] and best[0] == _NEG and lead_of[0] == 0
    assert chip_smoke.election_pairs(case[0], case[2]) == 256 * 255 // 2


def test_rows_without_a_leader_get_zero_and_neg() -> None:
    r"""Rows with no leader below them in their group (padding rows,
    first rows of a group) get index 0 and ``_NEG``, as ``torch.argmax``
    over a row of ``_NEG`` gives; non-rejected rows get their best leader
    too (every output row is held)."""
    rng = np.random.default_rng(SEED + 5)
    case = chip_smoke.election_case(rng, 256, 64, "t=0.3 groups")
    for mode in MODES:
        leads, lead_of, best = _check(case, mode)
        none = best == _NEG
        assert none.any() and (lead_of[none] == 0).all()
        assert (~case[0] & ~none).any()


def test_election_pairs_counts_the_pairs() -> None:
    rejected = np.array([1, 1, 0, 1, 1, 1], bool)
    group = np.array([0, 0, 0, 1, 0, 1], np.int32)
    # group 0: rows 0, 1, 2, 4 (rejected 0, 1, 4): below 1: {0}; 2: {0, 1};
    # 4: {0, 1}; group 1: rows 3, 5: below 5: {3}
    assert chip_smoke.election_pairs(rejected, group) == 1 + 2 + 2 + 1


def test_election_bound_counts_pairs_or_packed_rows() -> None:
    r"""The bound of the kernel's contract: the rejected rows' packed bits
    and popcounts, the flags, the plan (a narrow round's step plan and
    ``sel``) and the outputs as bytes, each leads pair (a rejected row
    against the lower rejected rows of its group) an AND + popcount as
    int8 operations, the larger of the two.  Beside it the full
    contract's bound of every row's pairs, charged the same way, never
    below the contract's."""
    rng = np.random.default_rng(SEED + 6)
    hbm, ops_s = chip_smoke.HBM_BYTES_PER_S, chip_smoke.INT8_OPS_PER_S
    for m, f, layout in ((512, 2048, "t=0.3 groups"), (2048, 2048, "fit round"), (4096, 64, "ties")):
        case = chip_smoke.election_case(rng, m, f, layout)
        rejected, group = case[0], case[2]
        wide = chip_smoke.election_args(case, "cpu", "wide")
        narrow = chip_smoke.election_args(case, "cpu", "narrow")
        leads = le.elect_leaders_plain(*wide)[0]
        bw, bn = chip_smoke._election_bound(wide, leads), chip_smoke._election_bound(narrow, leads)
        full = chip_smoke.election_pairs(rejected, group)
        lead_pairs = chip_smoke._pairs(rejected, group, rejected)
        best_pairs = chip_smoke._pairs(rejected & ~leads.numpy(), group, leads.numpy())
        assert bw["pairs"] == bn["pairs"] == lead_pairs < full and bw["full_pairs"] == full
        assert 0 < bw["best_pairs"] == best_pairs < lead_pairs
        rows = m * (1 + 1 + 4 + 1 + 4 + 4) + int(rejected.sum()) * (f // 8 + 4)
        for b, plan in ((bw, m * (8 + 4)), (bn, 4 * m * (8 + 4) + m * 8)):
            t_bytes, t_ops = (rows + plan) / hbm, 2 * f * lead_pairs / ops_s
            assert b["bound_ms"] == pytest.approx(max(t_bytes, t_ops) * 1e3)
            assert b["bound_by"] == ("bytes" if t_bytes >= t_ops else "operations")
            t_full = max((rows + plan + 4 * m) / hbm, 2 * f * full / ops_s)
            assert b["bound_full_ms"] == pytest.approx(t_full * 1e3) and b["bound_full_ms"] >= b["bound_ms"]
        assert bn["bound_ms"] >= bw["bound_ms"]
    assert bw["bound_by"] == "bytes" and bn["bound_by"] == "bytes"  # 64 bits a row: few operations


def _numpy_contract(rejected, force, group, threshold, sims):
    r"""The kernel's contract by loops over numpy: leads on every row; for
    the rejected rows that do not lead, the largest sim of a lower leader
    of their group and the lowest such leader (0 and ``_NEG`` where there
    is none); every other row 0 and ``_NEG``."""
    m = len(rejected)
    leads = np.zeros(m, bool)
    for j in np.flatnonzero(rejected):
        lower = [i for i in range(j) if rejected[i] and group[i] == group[j]]
        hit = not (np.float32(_NEG) < threshold) or any(sims[j, i] >= threshold for i in lower)
        leads[j] = force[j] or not hit
    lead_of = np.zeros(m, np.int32)
    best = np.full(m, _NEG, np.float32)
    for j in np.flatnonzero(rejected & ~leads):
        for i in range(j):
            if leads[i] and group[i] == group[j] and (sims[j, i] > best[j] or best[j] == _NEG):
                best[j], lead_of[j] = sims[j, i], i
    return leads, lead_of, best


@pytest.mark.parametrize("threshold", [0.3, 1.0, -2.0])
@pytest.mark.parametrize("layout", ["fit round", "ties", "force lead", "one group"])
def test_contract_rows_match_a_numpy_reference(layout, threshold) -> None:
    r"""The rows the kernel's contract covers, from the plain version with
    packed rows (a narrow round) and with the plan (a wide round), equal a
    numpy reference over the f64-free f32 sims of the rows: leads on every
    row, lead_of and best_lead_sim on the rejected rows that do not lead.
    A threshold at ``_NEG`` leaves only the rows struck twice leading."""
    rng = np.random.default_rng(SEED + 8 + chip_smoke.ELECTION_LAYOUTS.index(layout))
    case = chip_smoke.election_case(rng, 160, 64, layout)
    rejected, force, group = case[0], case[1], case[2]
    sims = le.tanimoto_gram(
        unpack_fingerprints_device(torch.from_numpy(case[4])).to(torch.int8),
        torch.from_numpy(case[5]),
    ).numpy()
    thr = np.float32(threshold)
    leads, lead_of, best = _numpy_contract(rejected, force, group, thr, sims)
    if threshold == -2.0:
        np.testing.assert_array_equal(leads, rejected & force)
    for plan in ("wide", "narrow"):
        args = list(chip_smoke.election_args(case, "cpu", plan))
        args[3] = torch.tensor(threshold, dtype=torch.float32)
        got = [a.numpy() for a in le.elect_leaders(*args)]
        np.testing.assert_array_equal(got[0], leads)
        c = rejected & ~leads
        assert c.any() or (threshold == 1.0 and layout != "ties")  # 1.0: duplicates only
        np.testing.assert_array_equal(got[1][c], lead_of[c])
        np.testing.assert_array_equal(got[2][c].view(np.int32), best[c].view(np.int32))


def test_wide_round_without_row_gram_matches_jax() -> None:
    r"""One wide insert round of the engine, the leader election from the
    packed rows through the step's sort plan and no row Gram, against
    JAX's ``_insert_round`` with the step's ``row_sims`` (its wide round):
    a fresh state's first round (every row on group 0, none with a
    candidate, so every pending row is rejected), a fifth of the rows
    struck twice; every table and the carried rows equal."""
    import jax
    from bblean_tpu.engine import batch as jb
    from bblean_tpu_torch.engine.state_io import state_from_numpy, state_to_numpy
    from bblean_tpu_torch.fingerprints import make_fake_fingerprints

    m, f = 64, 2048
    rng = np.random.default_rng(SEED + 9)
    fps = make_fake_fingerprints(m, seed=SEED + 9)
    valid = np.ones(m, bool)
    valid[-3:] = False
    jrows = jb._prep_fp_rows(jnp.asarray(fps), jnp.asarray(valid), f)
    trows = tb._prep_fp_rows(torch.from_numpy(fps), torch.from_numpy(valid), f)
    jstate = jb._init_state(256, 16, 8, f, 64)
    tstate = state_from_numpy({k: np.asarray(v) for k, v in jstate._asdict().items()}, "cpu")
    pending, group = valid, np.zeros(m, np.int32)
    strikes = np.where(rng.random(m) < 0.2, 2, 0).astype(np.int32)
    cent, pop = jrows[2], jrows[4]
    inter = lax.dot_general(cent, cent, (((1,), (1,)), ((), ())), preferred_element_type=jnp.int32)
    inter = inter.astype(jnp.float32)
    row_sims = inter / jnp.maximum((pop[:, None] + pop[None, :]).astype(jnp.float32) - inter, 1.0)
    rnd = jax.jit(jb._insert_round, static_argnames=("criterion", "use_pallas"))
    jout = rnd(
        jstate, jnp.asarray(pending), jnp.full((m,), -1, jnp.int32), jnp.asarray(strikes),
        jnp.asarray(group), *jrows, jnp.float32(0.3), jnp.float32(0.05),
        criterion="diameter", use_pallas=False, row_sims=row_sims,
    )
    tpending, tgroup = torch.from_numpy(pending), torch.from_numpy(group)
    order, skey, items = tb.sorted_search_plan(torch.where(tpending, tgroup, tstate.g_ls.shape[0] - 1))
    tout = tb._insert_round(
        tstate, tpending, torch.full((m,), -1, dtype=torch.int32), torch.from_numpy(strikes),
        tgroup, *trows, torch.tensor(0.3), torch.tensor(0.05), criterion="diameter",
        search_plan=(trows[3][order], trows[4][order], skey, order, items),
    )
    got, want = state_to_numpy(tout[0]), {k: np.asarray(v) for k, v in jout[0]._asdict().items()}
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for a, b in zip(jout[1:], tout[1:]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assigned = np.asarray(jout[2])
    assert (assigned >= 0).sum() > 3 and int(want["num"]) < pending.sum()  # leaders and joins


def _listed(rejected: np.ndarray, plan: tuple) -> tuple[np.ndarray, np.ndarray]:
    r"""The rejected rows and their groups as the kernel lists them from
    ``plan`` (``(order, skey)`` over the call's rows, or ``(order, skey,
    sel)`` over a step whose rows ``sel`` are the call's): the plan's
    order, each step row mapped to its call row and kept where that row
    is rejected."""
    order, skey = plan[0].numpy(), plan[1].numpy()
    pos = np.arange(len(order))
    if len(plan) == 3:
        pos = np.full(len(order), -1)
        pos[plan[2].numpy()] = np.arange(len(rejected))
    rows = pos[order]
    keep = rows >= 0
    keep[keep] = rejected[rows[keep]]
    return rows[keep], skey[keep]


@pytest.mark.parametrize("layout", chip_smoke.ELECTION_LAYOUTS)
def test_plans_list_the_rejected_rows_by_group(layout) -> None:
    r"""``chip_smoke.election_args``'s plans, as the card's checks pass
    them: the wide one and the narrow one (the case's rows a selection of
    a step four times as wide, padding rows on falling step rows) list
    every rejected row once, by (group, row), with its own group."""
    rng = np.random.default_rng(SEED + 10 + chip_smoke.ELECTION_LAYOUTS.index(layout))
    case = chip_smoke.election_case(rng, 256, 64, layout)
    for plan in ("wide", "narrow"):
        args = chip_smoke.election_args(case, "cpu", plan)
        listed, keys = _listed(case[0], args[7])
        np.testing.assert_array_equal(np.sort(listed), np.flatnonzero(case[0]))
        np.testing.assert_array_equal(keys, case[2][listed])
        assert (np.lexsort((listed, keys)) == np.arange(len(listed))).all()
    sel = args[7][2].numpy()
    assert len(np.unique(sel)) == 256 and sel.max() < 4 * 256
    assert (np.diff(sel[case[3]]) > 0).all() and (np.diff(sel[~case[3]]) < 0).all()


def _recorded_fit(monkeypatch, n: int, f: int) -> dict:
    r"""A fit on the CPU of ``n`` fake rows of ``f`` bits at t = 0.3 in
    batches of 64 with every ``elect_leaders`` call recorded: each call
    from the packed rows with a plan whose listing (``_listed``) holds
    every rejected row once, by (group, row), with its own group.
    Returns the rounds, the wide and narrow calls and the rejected rows
    each kind listed."""
    from bblean_tpu_torch import BatchTree
    from bblean_tpu_torch.fingerprints import make_fake_fingerprints

    calls = {"round": 0, "wide": 0, "narrow": 0, "wide rejected": 0, "narrow rejected": 0}
    rounds = tb._insert_round

    def counted_round(*args, **kwargs):
        calls["round"] += 1
        return rounds(*args, **kwargs)

    def recorded(rejected, force_lead, row_group, threshold, sims=None, row_pk=None,
                 row_pop=None, plan=None):
        assert sims is None and row_pk is not None and row_pop is not None and plan is not None
        kind = "wide" if len(plan) == 2 else "narrow"
        calls[kind] += 1
        listed, keys = _listed(rejected.numpy(), plan)
        np.testing.assert_array_equal(np.sort(listed), np.flatnonzero(rejected.numpy()))
        np.testing.assert_array_equal(keys, row_group.numpy()[listed])
        assert (np.lexsort((listed, keys)) == np.arange(len(listed))).all()
        calls[f"{kind} rejected"] += len(listed)
        return le.elect_leaders(rejected, force_lead, row_group, threshold, sims, row_pk, row_pop, plan)

    monkeypatch.setattr(tb, "_insert_round", counted_round)
    monkeypatch.setattr(tb, "elect_leaders", recorded)
    fps = make_fake_fingerprints(n, f, seed=5)
    tree = BatchTree(f, threshold=0.3, batch_size=64, device="cpu")
    tree.fit_packed(fps, range(n))
    return calls


def test_insert_round_elects_through_the_wrapper(monkeypatch) -> None:
    r"""Each insert round (diameter) makes one call of ``elect_leaders``
    from the packed rows, without sims: wide rounds with the step's sort
    plan, narrow rounds with the step's plan and their rows' selection of
    it; every plan lists the call's rejected rows by (group, row) as the
    kernel reads it (``_recorded_fit``)."""
    calls = _recorded_fit(monkeypatch, 300, 256)
    assert calls["round"] > 0 and calls["wide"] + calls["narrow"] == calls["round"]
    assert calls["wide"] > 0 and calls["narrow"] > 0 and calls["wide rejected"] > 0


def test_narrow_rounds_plans_list_their_rejected_rows(monkeypatch) -> None:
    r"""A fit whose narrow rounds reject rows (2048 bits): the step's plan,
    through the narrow round's selection of the step's rows, lists them
    by (group, row) (``_recorded_fit``)."""
    calls = _recorded_fit(monkeypatch, 400, 2048)
    assert calls["narrow rejected"] > 0 and calls["wide rejected"] > 0
