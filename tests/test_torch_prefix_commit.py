r"""The insert round's merge tests (``ops/prefix_commit.py``) against JAX.

One round's three merge tests (the individual screen, pass 1 and pass 2 of
the prefix commits) are rebuilt here in JAX as
``bblean_tpu/engine/batch.py:385-470`` writes them (``jnp.cumsum``,
``lax.cummax``, ``bblean_tpu.ops.merges.merge_accept_batch``) and run in
the port as the batch engine runs them: ``prefix_commit_moments_plain``
(what the wrapper runs for CPU tensors) and ``merge_accept_from_moments``.
The three accept masks must equal JAX's exactly, and every moment must
equal the int64 sums taken here in numpy (the radius criteria's vote in
numpy float32).  Inputs are ``chip_smoke.prefix_commit_case``'s: every
layout of segments (all singletons, one segment of all M rows, mixed
lengths, long runs, none accepted), buffer rows with sums past 2^16 (Ksq
past 2^31), and sums at the f32 vote's edge, for all six criteria.  The
tail's split from ``merge_accept_batch`` is held bit-equal to the function
as it was before the split.  The CUDA kernel itself runs only on a card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 2e), where it is
held to the plain version.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import chip_smoke
from bblean_tpu.engine import batch as jb
from bblean_tpu.ops.merges import merge_accept_batch as jax_merge_accept_batch
from bblean_tpu_torch.engine import batch as tb
from bblean_tpu_torch.ops import prefix_commit as pc
from bblean_tpu_torch.ops.merges import (
    DEVICE_MERGES,
    merge_accept_batch,
    merge_accept_from_moments,
    merge_moments,
    moment_count,
)

torch.set_num_threads(2)

TOLERANCE = chip_smoke.PREFIX_TOLERANCE
SEED = 20261017


def _threshold(criterion: str) -> float:
    return chip_smoke.PREFIX_THRESHOLD.get(criterion, chip_smoke.PREFIX_DEFAULT_THRESHOLD)


def _jax_round(criterion, row_ls, row_n, cand_ls, cand_n, accept, best):
    r"""The screen's mask and, on ``accept`` and ``best``, the sort, the
    segment starts and the masks of pass 1 and pass 2 (before the longest
    prefix), as the JAX engine's round computes them."""
    row_ls, row_n, cand_ls, cand_n = map(jnp.asarray, (row_ls, row_n, cand_ls, cand_n))
    accept, best = jnp.asarray(accept), jnp.asarray(best)
    threshold = _threshold(criterion)
    screen = jax_merge_accept_batch(
        criterion, threshold, cand_ls + row_ls, cand_n + row_n, cand_ls, cand_n,
        row_n, tolerance=TOLERANCE,
    )
    m = row_ls.shape[0]
    akey = jnp.where(accept, best, jnp.int32(1 << 30))
    aorder, _agrp, astart = jb._group_ids_by_key(akey)
    a_ok = accept[aorder]
    seg_start = lax.cummax(jnp.where(astart, jnp.arange(m, dtype=jnp.int32), 0))
    cand_ls_s = cand_ls[aorder]
    cand_n_s = cand_n[aorder]

    def commit(inc):
        s_ls = jnp.where(inc[:, None], row_ls[aorder], 0)
        s_n = jnp.where(inc, row_n[aorder], 0)
        excl_ls = jnp.cumsum(s_ls, axis=0) - s_ls
        excl_n = jnp.cumsum(s_n) - s_n
        pre_ls = excl_ls - excl_ls[seg_start]
        pre_n = excl_n - excl_n[seg_start]
        return jax_merge_accept_batch(
            criterion, threshold, cand_ls_s + pre_ls + s_ls, cand_n_s + pre_n + s_n,
            cand_ls_s + pre_ls, cand_n_s + pre_n, s_n, tolerance=TOLERANCE,
        ) & inc

    acc_pref = commit(a_ok)
    acc2 = commit(acc_pref)
    return tuple(np.asarray(a) for a in (screen, aorder, seg_start, acc_pref, acc2))


def _np_moments(criterion, x, new_n, y, old_n):
    r"""``merge_moments`` in numpy: int64 sums, the vote in float32."""

    def side(v, n):
        out = [v.sum(1), (v * v).sum(1)]
        if criterion in ("radius", "tolerance-radius"):
            half = n.astype(np.float32)[:, None] * np.float32(0.5)
            vote = v.astype(np.float32) >= half
            c = np.where((n <= 1)[:, None], np.clip(v, 0, 1), vote).astype(np.int64)
            out += [(v + c).sum(1), ((v + c) * (v + c)).sum(1)]
        return out

    if moment_count(criterion) == 0:
        return np.zeros((0, x.shape[0]), np.int64)
    out = side(x, new_n)
    if criterion.startswith("tolerance-"):
        out += side(y, np.maximum(old_n, 2))
    return np.stack(out)


def _np_prefix(row_ls, cand_ls, order, mask, seg_start):
    r"""(x, y) int64 of the module's contract, by a loop over the rows."""
    s = np.where(mask[:, None], row_ls[order], 0).astype(np.int64)
    pre = np.zeros_like(s)
    for i in range(1, len(s)):
        if seg_start[i] != i:
            pre[i] = pre[i - 1] + s[i - 1]
    y = cand_ls[order].astype(np.int64) + pre
    return y + s, y


def _check_round(criterion, case, with_jax: bool = True) -> dict:
    r"""Run one round's three merge tests in the port; assert its masks
    equal JAX's (``with_jax``) and the unsplit function's on the same sums
    built in numpy, and its moments the numpy sums; return JAX's masks."""
    row_ls, row_n, cand_ls, cand_n, accept, best = case
    screen, aorder, seg_start, acc_pref, acc2 = _jax_round(criterion, *case)
    threshold = _threshold(criterion)
    t = torch.from_numpy
    t_row_ls, t_cand_ls, t_row_n, t_cand_n = t(row_ls), t(cand_ls), t(row_n), t(cand_n)

    def check(mom, got, want, x, new_n, y, old_n, nom_n, inc=None):
        np.testing.assert_array_equal(mom.numpy(), _np_moments(criterion, x, new_n, y, old_n))
        before = _accept_before(
            criterion, threshold, t(x), t(new_n), t(y), t(old_n), t(nom_n), TOLERANCE
        )
        before = before if inc is None else before & inc
        assert torch.equal(got, before)
        if with_jax:
            np.testing.assert_array_equal(got.numpy(), want)

    # The screen: every row its own segment, nothing before it
    merged_n = t_cand_n + t_row_n
    mom = pc.prefix_commit_moments_plain(criterion, t_row_ls, t_cand_ls, merged_n, t_cand_n)
    got = merge_accept_from_moments(
        criterion, threshold, mom, merged_n, t_cand_n, t_row_n, tolerance=TOLERANCE,
    )
    cand64 = cand_ls.astype(np.int64)
    check(mom, got, screen, cand64 + row_ls, merged_n.numpy(), cand64, cand_n, row_n)

    # Passes 1 and 2 on the JAX sort (pass 2 on the port's pass 1)
    order, seg = t(aorder.copy()).long(), t(seg_start.copy()).long()
    inc = t(accept)[order]
    for want in (acc_pref, acc2):
        new_n, old_n, s_n = tb._prefix_counts(inc, t_row_n[order], t_cand_n[order], seg)
        mom = pc.prefix_commit_moments_plain(
            criterion, t_row_ls, t_cand_ls, new_n, old_n, order=order, mask=inc,
            seg_start=seg,
        )
        got = merge_accept_from_moments(
            criterion, threshold, mom, new_n, old_n, s_n, tolerance=TOLERANCE,
        ) & inc
        x, y = _np_prefix(row_ls, cand_ls, aorder, inc.numpy(), seg_start)
        check(mom, got, want, x, new_n.numpy(), y, old_n.numpy(), s_n.numpy(), inc)
        inc = got
    return {"screen": screen, "acc_pref": acc_pref, "acc2": acc2}


@pytest.mark.parametrize("criterion", DEVICE_MERGES)
@pytest.mark.parametrize("layout", chip_smoke.PREFIX_LAYOUTS)
def test_round_matches_jax(criterion, layout) -> None:
    rng = np.random.default_rng(SEED + chip_smoke.PREFIX_LAYOUTS.index(layout))
    masks = _check_round(criterion, chip_smoke.prefix_commit_case(rng, 64, 64, layout))
    if criterion != "never-merge" and layout in ("mixed", "t=0.3 runs"):
        # Both outcomes occur, and pass 1 fails some accepted rows
        assert 0 < masks["screen"].sum() < 64
        assert 0 < masks["acc_pref"].sum()


@pytest.mark.parametrize("criterion", DEVICE_MERGES)
@pytest.mark.parametrize("kind", ["big", "vote edge"])
def test_round_matches_jax_edges(criterion, kind) -> None:
    rng = np.random.default_rng(SEED + 7)
    layout = "mixed" if kind == "big" else "singletons"
    case = chip_smoke.prefix_commit_case(
        rng, 64, 64, layout, big=kind == "big", vote_edge=kind == "vote edge"
    )
    row_ls, row_n, cand_ls, cand_n = case[:4]
    if kind == "big":
        assert row_ls.max() >= 1 << 16
        x = cand_ls.astype(np.int64) + row_ls
        assert (x * x).sum(1).max() >= 1 << 31
        # JAX's f32 iSIM is inexact past 2^24, and the radius complement
        # (isim_n1 * (n + 1) - isim_n * (n - 1)) / 2 multiplies that error
        # by n (about 2^16 here): those masks are held to the unsplit
        # function only (the port's iSIM is exact, ops/isim.py)
        with_jax = "radius" not in criterion
    else:
        with_jax = True
        x = cand_ls.astype(np.int64) + row_ls
        n = (cand_n + row_n).astype(np.int64)
        assert (2 * x[2::2] == n[2::2, None]).sum() > 0  # merged ties
        assert (2 * cand_ls[1::2] == cand_n[1::2, None]).sum() > 0  # pre-merge ties
        assert (x[0] == 1 << 24).any() and n[0] == (1 << 25) + 1
    _check_round(criterion, case, with_jax)


@pytest.mark.parametrize(
    "m,f,layout,criterion",
    [
        (2048, 64, "t=0.3 runs", "diameter"),
        (2048, 64, "one segment", "tolerance-radius"),
        (64, 2048, "mixed", "radius"),
        (64, 2048, "t=0.3 runs", "tolerance-legacy"),
        (2048, 2048, "t=0.3 runs", "diameter"),
        (2048, 2048, "mixed", "tolerance-diameter"),
    ],
)
def test_round_matches_jax_at_width(m, f, layout, criterion) -> None:
    rng = np.random.default_rng(SEED + m + f)
    _check_round(criterion, chip_smoke.prefix_commit_case(rng, m, f, layout))


# ``ops/isim.py`` and ``ops/merges.py`` as they were before the moments and
# the tail were split (their cohesion arithmetic, verbatim)
def _isim_before(ls, n):
    ls64 = ls.to(torch.int64)
    k = ls64.sum(dim=-1)
    ksq = (ls64 * ls64).sum(dim=-1)
    a = (ksq - k) // 2
    denom = a + n.to(torch.int64) * k - ksq
    isim = (a.to(torch.float64) / denom.to(torch.float64)).to(torch.float32)
    isim = torch.where(k == 0, 1.0, isim)
    return torch.where(n < 2, torch.nan, isim)


def _radius_before(ls, n):
    half = n.to(torch.float32)[:, None] * 0.5
    vote = (ls.to(torch.float32) >= half).to(torch.uint8)
    single = ls.clamp(0, 1).to(torch.uint8)
    cent = torch.where(n[:, None] <= 1, single, vote)
    ls1 = ls + cent.to(ls.dtype)
    nf = n.to(torch.float32)
    isim_n = torch.where(n < 2, 0.0, _isim_before(ls, n))
    isim_n1 = _isim_before(ls1, n + 1)
    return (isim_n1 * (nf + 1) - isim_n * (nf - 1)) * 0.5


def _accept_before(criterion, threshold, new_ls, new_n, old_ls, old_n, nom_n, tolerance):
    if criterion == "never-merge":
        return torch.zeros(new_n.shape, dtype=torch.bool)
    radius = criterion in ("radius", "tolerance-radius")
    cohesion = _radius_before if radius else _isim_before
    new_c = cohesion(new_ls, new_n)
    screen = new_c >= threshold
    if criterion in ("radius", "diameter"):
        return screen
    old_c = torch.where(old_n < 2, 0.0, cohesion(old_ls, old_n.clamp_min(2)))
    if criterion in ("tolerance-diameter", "tolerance-radius"):
        offset = math.exp(-1e-3 * 1000)
        tol = (tolerance * (torch.exp(-1e-3 * old_n.to(torch.float32)) - offset)).clamp_min(0.0)
        return screen & ((old_n == 1) | (new_c >= old_c - tol))
    trivial = (old_n == 1) | (nom_n != 1)
    nf, of = new_n.to(torch.float32), old_n.to(torch.float32)
    growth = (new_c * nf - old_c * (of - 1)) * 0.5 >= old_c - tolerance
    return screen & (trivial | growth)


@pytest.mark.parametrize("criterion", DEVICE_MERGES)
@pytest.mark.parametrize("scale", [1, 1 << 12])
def test_tail_equals_merge_accept_batch_before_the_split(criterion, scale) -> None:
    r"""Random sums at counts 0-39 (``scale`` 1) and 0-159,744 (4096):
    ``merge_accept_from_moments(merge_moments(...))`` and
    ``merge_accept_batch`` both equal the unsplit function bit for bit,
    with a threshold at the middle of the new cohesions' range."""
    rng = np.random.default_rng(SEED + scale)
    c, f = 500, 256
    old_n = torch.from_numpy(rng.integers(0, 40, c) * scale).to(torch.int32)
    nom_n = torch.from_numpy(np.where(rng.random(c) < 0.5, 1, rng.integers(1, 40, c) * scale)).to(torch.int32)
    new_n = old_n + nom_n
    p = rng.random((c, 1))
    old_ls = torch.from_numpy(rng.binomial(old_n.numpy()[:, None], p, (c, f))).to(torch.int32)
    new_ls = old_ls + torch.from_numpy(rng.binomial(nom_n.numpy()[:, None], p, (c, f))).to(torch.int32)
    threshold = float(_isim_before(new_ls, new_n).nanmedian())
    want = _accept_before(criterion, threshold, new_ls, new_n, old_ls, old_n, nom_n, TOLERANCE)
    mom = merge_moments(criterion, new_ls, new_n, old_ls, old_n)
    assert mom.shape == (moment_count(criterion), c) and mom.dtype == torch.int64
    got = merge_accept_from_moments(criterion, threshold, mom, new_n, old_n, nom_n, tolerance=TOLERANCE)
    assert torch.equal(got, want)
    assert torch.equal(
        merge_accept_batch(criterion, threshold, new_ls, new_n, old_ls, old_n, nom_n, tolerance=TOLERANCE),
        want,
    )
    if criterion != "never-merge":
        assert 0 < int(want.sum()) < c


def test_chunks_fill_the_card() -> None:
    r"""At both widths of a fit's rounds (2048 bits, 8 column tiles) on 132
    SMs, chunks of 16 rows (a block's two items take 64 KiB, three blocks
    an SM) give every SM at least four (chunk, tile) items; where rows are
    few, the chunks shrink, down to one row."""
    for m, want in ((8192, 16), (2048, 16)):
        rows = pc._chunk_rows(m, 2048, 132)
        items = -(-m // rows) * -(-2048 // pc._TILE_COLS)
        assert rows == want and items >= 4 * 132
    assert pc._chunk_rows(64, 64, 132) == 1


def test_prefix_bound_charges_the_rows_in_the_mask() -> None:
    r"""The bound reads ``cand_ls`` whole and of ``row_ls`` only the rows
    the mask lets in: a pass with none of 8,192 rows in its mask costs
    half the bytes of the tables that a screen (every row read) costs."""
    m, f = 8192, 2048
    full = chip_smoke._prefix_bound(m, f, 2, False, m)
    none = chip_smoke._prefix_bound(m, f, 2, True, 0)
    quarter = chip_smoke._prefix_bound(m, f, 2, True, m // 4)
    tables = m * f * 4 / chip_smoke.HBM_BYTES_PER_S * 1e3
    assert full["bound_by"] == "bytes" and abs(full["bound_ms"] - 2 * tables) < 0.01 * tables
    assert abs(none["bound_ms"] - tables) < 0.01 * tables
    assert abs(quarter["bound_ms"] - none["bound_ms"] - tables / 4) < 1e-12 + 1e-9 * tables


def test_insert_round_tests_through_the_wrapper(monkeypatch) -> None:
    r"""Each insert round makes three calls of ``prefix_commit_moments``
    (the screen, pass 1, pass 2) and no call of ``merge_accept_batch``
    beyond the leader election's cohesion check."""
    from bblean_tpu_torch import BatchTree
    from bblean_tpu_torch.fingerprints import make_fake_fingerprints

    calls = {"prefix": 0, "accept": 0, "round": 0}

    def counted(name, fn):
        def call(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)

        return call

    monkeypatch.setattr(tb, "prefix_commit_moments", counted("prefix", tb.prefix_commit_moments))
    monkeypatch.setattr(tb, "merge_accept_batch", counted("accept", tb.merge_accept_batch))
    monkeypatch.setattr(tb, "_insert_round", counted("round", tb._insert_round))
    fps = make_fake_fingerprints(300, 256, seed=5)
    tree = BatchTree(256, threshold=0.3, batch_size=64, device="cpu")
    tree.fit_packed(fps, range(300))
    assert calls["round"] > 0
    assert calls["prefix"] == 3 * calls["round"]
    assert calls["accept"] == calls["round"]


def _np_need_moments(criterion, case_args):
    r"""The contract's moments of one call by the loop of ``_np_prefix``
    (rows outside ``need`` zeros); ``case_args`` in numpy."""
    _c, row_ls, cand_ls, new_n, old_n, order, mask, seg, need = case_args
    m = row_ls.shape[0]
    order = np.arange(m) if order is None else order
    mask = np.ones(m, bool) if mask is None else mask
    seg = np.arange(m) if seg is None else seg
    x, y = _np_prefix(row_ls, cand_ls, order, mask, seg)
    mom = _np_moments(criterion, x, new_n, y, old_n)
    return np.where(need, mom, 0)


@pytest.mark.parametrize("call", ["screen", "pass 1", "pass 2"])
@pytest.mark.parametrize("criterion", DEVICE_MERGES)
@pytest.mark.parametrize("layout", chip_smoke.PREFIX_LAYOUTS)
def test_need_keeps_the_needed_rows(layout, criterion, call) -> None:
    r"""With ``need`` (as the engine passes it: the screen's candidates,
    each pass's mask), the plain version's moments equal the full
    contract's on the needed rows and are zero elsewhere, and the call's
    accept mask equals JAX's round's (the screen's ANDed with the rows the
    engine keeps)."""
    rng = np.random.default_rng(SEED + chip_smoke.PREFIX_LAYOUTS.index(layout))
    case = chip_smoke.prefix_commit_case(rng, 64, 64, layout)
    full, nom = chip_smoke.prefix_commit_uses(criterion, case, "cpu")[call]
    args, nom_need = chip_smoke.prefix_commit_uses(criterion, case, "cpu", need=True)[call]
    need = args[8]
    assert need is not None and torch.equal(nom, nom_need)
    if call != "screen":
        assert torch.equal(need, args[6])
    mom = pc.prefix_commit_moments_plain(*args)
    assert torch.equal(mom[:, need], pc.prefix_commit_moments_plain(*full)[:, need])
    assert not bool(mom[:, ~need].any())
    np.testing.assert_array_equal(
        mom.numpy(), _np_need_moments(criterion, [a.numpy() if isinstance(a, torch.Tensor) else a for a in args])
    )
    got = chip_smoke.prefix_commit_accept(args, nom, mom)
    assert torch.equal(got, chip_smoke.prefix_commit_accept(full, nom, pc.prefix_commit_moments_plain(*full)) & need)
    screen, aorder, _seg, acc_pref, acc2 = _jax_round(criterion, *case)
    if call == "screen":
        np.testing.assert_array_equal(got.numpy(), screen & need.numpy())
    else:
        assert np.array_equal(args[5].numpy(), aorder)
        np.testing.assert_array_equal(got.numpy(), acc_pref if call == "pass 1" else acc2)


@pytest.mark.parametrize("kind", chip_smoke.PREFIX_STRESS)
def test_lookback_cases_on_the_cpu(kind) -> None:
    r"""The card's look-back stress cases, cut to 203 rows of 64 columns in
    chunks of 4: the plain version (with ``need``) equals the contract's
    moments by a loop over the rows; each case holds what it claims."""
    rows, m = 4, 203
    case = chip_smoke.prefix_lookback_case(np.random.default_rng(SEED + 11), m, 64, rows, kind)
    args = tuple(torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in case)
    mom = pc.prefix_commit_moments_plain(*args)
    np.testing.assert_array_equal(mom.numpy(), _np_need_moments(case[0], case))
    need, seg = case[8], case[7]
    assert m % rows and need.any() and not need.all() or kind in ("one segment", "chunk-aligned segments")
    if kind == "one segment":
        assert not seg.any() and need.all()
    elif kind == "chunk-aligned segments":
        starts = np.flatnonzero(seg == np.arange(m))
        assert len(starts) > 1 and not (starts % rows).any()
    elif kind == "zero stretches":
        assert not (case[6] | need)[4 * rows:m - 3 * rows].any()
    elif kind == "screen stretches":
        assert seg is None and case[5] is None
    assert np.array_equal(chip_smoke._prefix_reads(args), (
        m if case[6] is None else case[6].sum(),
        need.sum() if seg is None else (m if case[6] is None else case[6].sum()),
        need.sum(),
    ))


def test_prefix_bound_charges_cand_ls_for_the_needed_rows() -> None:
    r"""With ``needed`` the bound reads ``cand_ls`` for those rows only (and
    the (M,) need flags): a pass with none needed and none in its mask
    reads almost nothing of the tables; without it the bound is the one
    that charges ``cand_ls`` whole."""
    m, f = 8192, 2048
    tables = m * f * 4 / chip_smoke.HBM_BYTES_PER_S * 1e3
    empty = chip_smoke._prefix_bound(m, f, 2, True, 0, 0)
    assert empty["bound_ms"] < 0.01 * tables
    half = chip_smoke._prefix_bound(m, f, 2, True, m // 2, m // 2)
    assert abs(half["bound_ms"] - empty["bound_ms"] - tables) < 1e-9 * tables
    assert chip_smoke._prefix_bound(m, f, 2, True, 7)["bound_ms"] == pytest.approx(
        chip_smoke._prefix_bound(m, f, 2, True, 7, m)["bound_ms"] - m / chip_smoke.HBM_BYTES_PER_S * 1e3,
        rel=1e-12,
    )


def test_insert_round_passes_need(monkeypatch) -> None:
    r"""Each insert round's three calls pass ``need``: the screen the rows
    whose result it keeps (pending, with a candidate, struck fewer than
    twice: rows beside them), each pass its mask."""
    from bblean_tpu_torch import BatchTree
    from bblean_tpu_torch.fingerprints import make_fake_fingerprints

    calls = []

    def recorded(criterion, row_ls, cand_ls, new_n, old_n, order=None, mask=None,
                 seg_start=None, need=None):
        calls.append((seg_start is None, mask, need))
        return pc.prefix_commit_moments(
            criterion, row_ls, cand_ls, new_n, old_n, order, mask, seg_start, need
        )

    monkeypatch.setattr(tb, "prefix_commit_moments", recorded)
    fps = make_fake_fingerprints(300, 256, seed=5)
    tree = BatchTree(256, threshold=0.3, batch_size=64, device="cpu")
    tree.fit_packed(fps, range(300))
    assert calls and len(calls) % 3 == 0
    for k, (screen, mask, need) in enumerate(calls):
        assert screen == (k % 3 == 0)
        assert need is not None and need.dtype == torch.bool
        if screen:
            assert mask is None
        else:
            assert mask is need
    assert any(bool((~need).any()) for _s, _m, need in calls[::3])
