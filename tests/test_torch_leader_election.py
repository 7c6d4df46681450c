r"""The insert round's leader election (``ops/leader_election.py``) against
JAX.

The election is rebuilt here in JAX as ``bblean_tpu/engine/batch.py:504-540``
writes it (the (M, M) planes, ``jnp.any``, ``jnp.argmax``, ``jnp.max``; in
narrow rounds the int8 Gram of the rejected rows by ``lax.dot_general``)
and run in the port as the batch engine runs it: ``elect_leaders_plain``
(what the wrapper runs for CPU tensors), with the step's sims and sort
plan (a wide round), with sims and no plan, and from the packed rows (a
narrow round).  ``leads`` and ``lead_of`` must equal JAX's exactly and
``best_lead_sim`` bit for bit.  Inputs are ``chip_smoke.election_case``'s
at 64-256 rows of 64 or 100 bits: every row on one group, groups as a
mid-fit round's, rows that tie (duplicates), rows struck twice, no
rejected row.  The CUDA kernel itself runs only on a card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 2f), where it is
held to the plain version.
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
MODES = {"wide": (True, True), "wide without plan": (True, False), "narrow": (False, False)}


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
    wide, plan = MODES[mode]
    args = list(chip_smoke.election_args(case, "cpu", wide, plan))
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
    rng = np.random.default_rng(SEED + 6)
    case = chip_smoke.election_case(rng, 512, 2048, "t=0.3 groups")
    wide = chip_smoke._election_bound(chip_smoke.election_args(case, "cpu", True))
    narrow = chip_smoke._election_bound(chip_smoke.election_args(case, "cpu", False))
    pairs = chip_smoke.election_pairs(case[0], case[2])
    o_m = 512 * (1 + 1 + 4 + 8 + 4 + 1 + 4 + 4)
    assert wide["bound_by"] == "bytes" and wide["pairs"] == pairs
    assert wide["bound_ms"] == pytest.approx((o_m + 4 * pairs) / chip_smoke.HBM_BYTES_PER_S * 1e3)
    rows = int(case[0].sum()) * 256 + 4 * 512
    assert narrow["bound_ms"] == pytest.approx((o_m + rows) / chip_smoke.HBM_BYTES_PER_S * 1e3)


def test_wrapper_runs_the_plain_version_on_the_cpu(monkeypatch) -> None:
    r"""CPU tensors take the plain version and launch nothing; the
    kernel's own path takes CUDA tensors only, and a kernel that does not
    build raises (no fallback)."""
    rng = np.random.default_rng(SEED + 7)
    args = chip_smoke.election_args(chip_smoke.election_case(rng, 64, 64, "t=0.3 groups"), "cpu", True)
    before = le.launches
    got, ref = le.elect_leaders(*args), le.elect_leaders_plain(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert le.launches == before
    with pytest.raises(ValueError, match="CUDA device"):
        le._launch(*args)

    def no_build(source):
        raise RuntimeError(f"nvcc failed to build {source}")

    monkeypatch.setattr(le, "_kernel_lib", None)
    monkeypatch.setattr("bblean_tpu_torch._build.load_kernel_library", no_build)
    with pytest.raises(RuntimeError, match="leader_election.cu"):
        le._lib()


def test_insert_round_elects_through_the_wrapper(monkeypatch) -> None:
    r"""Each insert round (diameter) makes one call of ``elect_leaders``:
    wide rounds with the step's sims and sort plan, narrow rounds with the
    packed rows and no plan; the labels are the plain engine's."""
    from bblean_tpu_torch import BatchTree
    from bblean_tpu_torch.fingerprints import make_fake_fingerprints

    calls = {"round": 0, "wide": 0, "narrow": 0}
    rounds = tb._insert_round

    def counted_round(*args, **kwargs):
        calls["round"] += 1
        return rounds(*args, **kwargs)

    def recorded(rejected, force_lead, row_group, threshold, sims=None, row_pk=None,
                 row_pop=None, plan=None):
        if sims is not None:
            assert plan is not None and row_pk is None and sims.shape == (rejected.shape[0],) * 2
            calls["wide"] += 1
        else:
            assert plan is None and row_pk is not None and row_pop is not None
            calls["narrow"] += 1
        return le.elect_leaders(rejected, force_lead, row_group, threshold, sims, row_pk, row_pop, plan)

    monkeypatch.setattr(tb, "_insert_round", counted_round)
    monkeypatch.setattr(tb, "elect_leaders", recorded)
    fps = make_fake_fingerprints(300, 256, seed=5)
    tree = BatchTree(256, threshold=0.3, batch_size=64, device="cpu")
    tree.fit_packed(fps, range(300))
    assert calls["round"] > 0 and calls["wide"] + calls["narrow"] == calls["round"]
    assert calls["wide"] > 0 and calls["narrow"] > 0
