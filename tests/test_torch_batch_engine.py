r"""The port's batch engine vs the JAX engine, unit by unit and whole.

One JAX engine state is captured after a few scan windows, passed through
numpy (``engine/state_io.py``) and fed to both engines together with the
same rows.  Every state table, ``assigned``, ``pending`` and ``strikes``
must be EQUAL.  The slice as a whole (``BatchTree.fit_packed`` ->
``assignments`` / ``cluster_mols``) must give equal labels to the JAX
``BatchTree`` on the same fingerprints and parameters; the configurations
are those of ``tests/test_batch_engine.py``, so that JAX compiles the same
programs.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bblean_tpu.engine import batch as jb
from bblean_tpu.fingerprints import make_fake_fingerprints
from bblean_tpu_torch.engine import batch as tb
from bblean_tpu_torch.engine.state_io import (
    state_from_numpy,
    state_to_numpy,
    states_from_stacked,
)

torch.set_num_threads(2)

SEED = 12620509540149709235
# tests/test_batch_engine.py::test_chunked_host_staging_matches_device_resident
CFG_C = dict(
    threshold=0.3, batch_size=64, route_block=64, initial_capacity=2048,
    stage_windows=2,
)
M = 64


def _jax_np(state) -> dict:
    return {f: np.array(getattr(state, f)) for f in jb.BatchState._fields}


def _jax_state(arrays: dict):
    return jb.BatchState(**{f: jnp.asarray(v) for f, v in arrays.items()})


def _assert_states_equal(ref: dict, got: dict) -> None:
    for f in jb.BatchState._fields:
        assert got[f].dtype == ref[f].dtype, f
        np.testing.assert_array_equal(got[f], ref[f], err_msg=f)


@pytest.fixture(scope="module")
def captured():
    r"""(fps, state after 2048 rows) of a JAX engine in configuration (c),
    and the prepared rows of the next batch for both engines."""
    fps = make_fake_fingerprints(2500, seed=SEED)
    tree = jb.BatchTree(2048, **CFG_C)
    tree.fit_packed(fps[:2048], range(2048))
    state = _jax_np(tree.state)
    packed = fps[2048 : 2048 + M]
    valid = np.ones(M, bool)
    valid[-5:] = False  # padding rows
    jrows = jb._prep_fp_rows(jnp.asarray(packed), jnp.asarray(valid), 2048)
    trows = tb._prep_fp_rows(torch.from_numpy(packed), torch.from_numpy(valid), 2048)
    for a, b in zip(jrows, trows):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    return fps, state, jrows, trows


def _scalars():
    return (
        (jnp.float32(0.3), jnp.float32(0.05)),
        (torch.tensor(0.3), torch.tensor(0.05)),
    )


def test_state_io_round_trips_a_jax_state(captured) -> None:
    _fps, state, _jr, _tr = captured
    port = state_from_numpy(state, "cpu")
    assert tuple(port._fields) == tuple(jb.BatchState._fields)
    assert port.t_pk.dtype == torch.uint8 and port.g_cent.dtype == torch.int8
    assert port.ls.dtype == torch.int32 and port.num.shape == ()
    _assert_states_equal(state, state_to_numpy(port))


def test_state_io_defaults_to_the_card(captured) -> None:
    r"""With no device named, both loaders put the state on the CUDA device:
    without a card they raise, and nothing gives way to the CPU."""
    _fps, state, _jr, _tr = captured
    stacked = {f: np.stack([v, v]) for f, v in state.items()}
    if torch.cuda.is_available():
        assert state_from_numpy(state).t_pk.device.type == "cuda"
        assert {s.n.device.type for s in states_from_stacked(stacked)} == {"cuda"}
        return
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        state_from_numpy(state)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        states_from_stacked(stacked)


def test_init_and_grow_state_match_jax() -> None:
    j = jb._grow_state(jb._init_state(64, 16, 8, 100, 32), 128, 32, 64)
    t = tb._grow_state(tb._init_state(64, 16, 8, 100, 32), 128, 32, 64)
    _assert_states_equal(_jax_np(j), state_to_numpy(t))


def test_route_groups_matches_jax(captured) -> None:
    _fps, state, jrows, trows = captured
    g_num = int(state["g_num"])
    block = 2
    assert g_num > 2 * block  # several route blocks, the last one partial
    pending = np.ones(M, bool)
    pending[::5] = False
    route = jax.jit(jb._route_groups, static_argnames=("block",))
    ref = route(
        jrows[2], jrows[4], jnp.asarray(state["g_cent"]),
        jnp.asarray(state["g_pops"]), jnp.asarray(state["g_num"]),
        jnp.asarray(pending), block=block,
    )
    got = tb._route_groups(
        trows[2], trows[4], torch.from_numpy(state["g_cent"]),
        torch.from_numpy(state["g_pops"]), g_num, torch.from_numpy(pending),
        block,
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.fixture(scope="module")
def one_round(captured):
    r"""One insert round from the captured state in both engines (routed
    rows; the port's sorted plan, its election from the packed rows: the
    wide rounds' form)."""
    _fps, state, jrows, trows = captured
    (jthr, jtol), (tthr, ttol) = _scalars()
    pending = jrows[1] > 0
    jgroup = jb._route_groups(
        jrows[2], jrows[4], jnp.asarray(state["g_cent"]),
        jnp.asarray(state["g_pops"]), jnp.asarray(state["g_num"]), pending, M,
    )
    rnd = jax.jit(jb._insert_round, static_argnames=("criterion", "use_pallas"))
    jstate, jpend, jassigned, jstrikes = rnd(
        _jax_state(state), pending, jnp.full((M,), -1, jnp.int32),
        jnp.zeros((M,), jnp.int32), jgroup, *jrows, jthr, jtol,
        criterion="diameter", use_pallas=False,
    )
    tpending = trows[1] > 0
    tgroup = torch.from_numpy(np.array(jgroup))
    tstate = state_from_numpy(state, "cpu")
    order, skey, items = tb.sorted_search_plan(
        torch.where(tpending, tgroup, tstate.g_ls.shape[0] - 1)
    )
    plan = (trows[3][order], trows[4][order], skey, order, items)
    tstate, tpend, tassigned, tstrikes = tb._insert_round(
        tstate, tpending, torch.full((M,), -1, dtype=torch.int32),
        torch.zeros(M, dtype=torch.int32), tgroup, *trows, tthr, ttol,
        criterion="diameter", search_plan=plan,
    )
    return (
        (_jax_np(jstate), np.asarray(jpend), np.asarray(jassigned), np.asarray(jstrikes)),
        (state_to_numpy(tstate), tpend.numpy(), tassigned.numpy(), tstrikes.numpy()),
    )


def test_insert_round_matches_jax(one_round) -> None:
    (jstate, jpend, jassigned, jstrikes), (tstate, tpend, tassigned, tstrikes) = one_round
    _assert_states_equal(jstate, tstate)
    np.testing.assert_array_equal(tpend, jpend)
    np.testing.assert_array_equal(tassigned, jassigned)
    np.testing.assert_array_equal(tstrikes, jstrikes)
    assert (jassigned >= 0).sum() > 0 and jpend.sum() > 0  # a partial round


def test_insert_round_in_call_search_matches_jax(captured) -> None:
    r"""The narrow rounds' form: no plan, row sims computed in-round."""
    _fps, state, jrows, trows = captured
    (jthr, jtol), (tthr, ttol) = _scalars()
    pending = np.asarray(jrows[1]) > 0
    pending[1::3] = False
    group = np.asarray(jb._route_groups(
        jrows[2], jrows[4], jnp.asarray(state["g_cent"]),
        jnp.asarray(state["g_pops"]), jnp.asarray(state["g_num"]),
        jnp.asarray(pending), M,
    ))
    strikes = np.zeros(M, np.int32)
    strikes[::4] = 2  # forced leaders
    rnd = jax.jit(jb._insert_round, static_argnames=("criterion", "use_pallas"))
    jout = rnd(
        _jax_state(state), jnp.asarray(pending), jnp.full((M,), -1, jnp.int32),
        jnp.asarray(strikes), jnp.asarray(group), *jrows, jthr, jtol,
        criterion="diameter", use_pallas=False,
    )
    tout = tb._insert_round(
        state_from_numpy(state, "cpu"), torch.from_numpy(pending),
        torch.full((M,), -1, dtype=torch.int32), torch.from_numpy(strikes),
        torch.from_numpy(group), *trows, tthr, ttol, criterion="diameter",
    )
    _assert_states_equal(_jax_np(jout[0]), state_to_numpy(tout[0]))
    for a, b in zip(jout[1:], tout[1:]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_refresh_touched_matches_jax(captured, one_round) -> None:
    r"""The step's refresh after the round above (its assigned rows), with
    the step's packed rows, their flags and its sort plan's order, as
    ``_batch_step_impl`` calls it."""
    _fps, _state, jrows, trows = captured
    (jstate, _jp, jassigned, _js), _port = one_round
    row_ls, row_n = np.asarray(jrows[0]), np.asarray(jrows[1])
    ref = jax.jit(jb._refresh_touched)(
        _jax_state(jstate), jnp.asarray(jassigned), jnp.asarray(row_ls),
        jnp.asarray(row_n),
    )
    order = torch.sort(torch.from_numpy(jassigned), stable=True).indices
    got = tb._refresh_touched(
        state_from_numpy(jstate, "cpu"), torch.from_numpy(jassigned),
        torch.from_numpy(row_ls), torch.from_numpy(row_n), trows[3], trows[5], order,
    )
    _assert_states_equal(_jax_np(ref), state_to_numpy(got))


@pytest.mark.parametrize("narrow", [0, M // 4])
def test_batch_step_matches_jax(captured, narrow) -> None:
    _fps, state, jrows, trows = captured
    (jthr, jtol), (tthr, ttol) = _scalars()
    kw = dict(criterion="diameter", block=M, max_rounds=24)
    jstate, jassigned, jenc = jb._batch_step(
        _jax_state(state), *jrows, jthr, jtol, use_pallas=False,
        narrow=narrow, **kw,
    )
    tstate, tassigned, tenc = tb._batch_step_impl(
        state_from_numpy(state, "cpu"), *trows, tthr, ttol, narrow=narrow, **kw,
    )
    _assert_states_equal(_jax_np(jstate), state_to_numpy(tstate))
    np.testing.assert_array_equal(tassigned.numpy(), np.asarray(jassigned))
    assert int(tenc) == int(jenc)


def test_split_groups_matches_jax(captured) -> None:
    r"""Top-K selection and the device split, with a fanout low enough
    that many groups are oversized."""
    _fps, state, _jr, _tr = captured
    counts = state["g_count"][: int(state["g_num"])]
    fanout = int(np.sort(counts)[-3])  # the two largest groups are above it
    assert (counts > fanout).sum() >= 2
    jstate, jleft = jb._split_topk_device(_jax_state(state), k=8, fanout=fanout)
    tstate, tleft = tb._split_topk_impl(state_from_numpy(state, "cpu"), k=8, fanout=fanout)
    _assert_states_equal(_jax_np(jstate), state_to_numpy(tstate))
    assert int(tleft) == int(jleft)


def test_scan_fit_packed_matches_jax(captured) -> None:
    r"""One scan window (16 batches of 64 rows, 452 valid) over a
    2-window staging chunk, as configuration (c)'s host path builds it."""
    fps, state, _jr, _tr = captured
    chunk = np.zeros((2048, fps.shape[1]), np.uint8)
    chunk[: 2500 - 2048] = fps[2048:]
    (jthr, jtol), (tthr, ttol) = _scalars()
    kw = dict(
        k=16, m=M, n_features=2048, criterion="diameter", block=M,
        max_rounds=24, narrow=M // 4, split_k=64, fanout=192,
    )
    jstate, jassigned, jencs = jb._scan_fit_packed(
        _jax_state(state), jnp.asarray(chunk), jnp.int32(0),
        jnp.int32(2500 - 2048), jthr, jtol, use_pallas=False, **kw,
    )
    tstate, tassigned, tencs = tb._scan_fit_packed_impl(
        state_from_numpy(state, "cpu"), torch.from_numpy(chunk), 0, 2500 - 2048,
        tthr, ttol, **kw,
    )
    _assert_states_equal(_jax_np(jstate), state_to_numpy(tstate))
    np.testing.assert_array_equal(tassigned.numpy(), np.asarray(jassigned))
    np.testing.assert_array_equal(tencs.numpy(), np.asarray(jencs))


def test_prep_buffer_rows_matches_jax(captured) -> None:
    r"""CF-row prep from pre-aggregated buffers: the captured state's pool
    rows as linear sums, with counts 0 (padding), 1 and several."""
    _fps, state, _jr, _tr = captured
    num_ls = int(state["num_ls"])
    assert num_ls >= 8
    row_ls = state["ls"][:num_ls]
    row_n = np.maximum(row_ls.max(axis=1), 1).astype(np.int32)
    row_n[:3] = (0, 1, 1)
    row_ls = row_ls.copy()
    row_ls[1] = np.clip(row_ls[1], 0, 1)  # a singleton's 0/1 sums
    ref = jb._prep_buffer_rows(jnp.asarray(row_ls), jnp.asarray(row_n))
    got = tb._prep_buffer_rows(torch.from_numpy(row_ls), torch.from_numpy(row_n))
    for a, b in zip(ref, got):
        assert b.dtype == {
            jnp.int32: torch.int32, jnp.int8: torch.int8, jnp.uint8: torch.uint8,
        }[a.dtype.type]
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("start", [0, 1500])
def test_reconstruct_ls_chunk_matches_jax(captured, start) -> None:
    r"""Dense sums of a slot range (pool rows and singleton tile bits); the
    second range runs past the table and clamps to its top slot."""
    _fps, state, _jr, _tr = captured
    assert 1500 + 1024 > state["n"].shape[0] > int(state["num"])
    ref = jb._reconstruct_ls_chunk(_jax_state(state), start, 1024, 2048)
    got = tb._reconstruct_ls_chunk(state_from_numpy(state, "cpu"), start, 1024, 2048)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_pool_dead_rows_matches_jax(captured) -> None:
    _fps, state, _jr, _tr = captured
    leaky = dict(state)
    leaky["num_ls"] = np.asarray(int(state["num_ls"]) + 3, np.int32)  # 3 dead rows
    for arrays, dead in ((state, 0), (leaky, 3)):
        ref = int(jb._pool_dead_rows(_jax_state(arrays)))
        got = int(tb._pool_dead_rows(state_from_numpy(arrays, "cpu")))
        assert got == ref == dead


@pytest.mark.parametrize("m", [M, M - 4])
def test_predict_step_matches_jax(captured, m) -> None:
    r"""M = 64 takes the sorted search in the port, 60 the per-row search;
    JAX runs its XLA search on the CPU either way."""
    fps, state, _jr, _tr = captured
    packed = np.concatenate([fps[2048 : 2048 + m - 8], fps[:8]])  # 8 known rows
    valid = np.ones(m, bool)
    valid[-3:] = False
    ref = jb._predict_step(
        _jax_state(state), jnp.asarray(packed), jnp.asarray(valid),
        n_features=2048, block=M, use_pallas=False,
    )
    got = tb._predict_step(
        state_from_numpy(state, "cpu"), torch.from_numpy(packed),
        torch.from_numpy(valid), int(state["g_num"]), n_features=2048, block=M,
    )
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert (got[1].numpy()[:-3] >= 0).all() and (got[1].numpy()[-3:] == -1).all()


def _fit_both(fps, **kw):
    j = jb.BatchTree(2048, **kw)
    j.fit_packed(fps, range(len(fps)))
    t = tb.BatchTree(2048, device="cpu", **kw)
    t.fit_packed(fps, range(len(fps)))
    return j, t


@pytest.mark.parametrize(
    "n_fps,kw",
    [
        # (a), (b): tests/test_batch_engine.py::_fit_batch
        (600, dict(threshold=0.3, batch_size=256, initial_capacity=1024, route_block=512)),
        (600, dict(threshold=0.65, batch_size=256, initial_capacity=1024, route_block=512)),
        # (c): splits, narrow rounds, multi-window chunked staging
        (2500, CFG_C),
    ],
    ids=["a-t0.3", "b-t0.65", "c-staged"],
)
def test_fit_matches_jax_labels(n_fps, kw) -> None:
    fps = make_fake_fingerprints(n_fps, seed=SEED)
    j, t = _fit_both(fps, **kw)
    assert t.num_clusters == j.num_clusters
    np.testing.assert_array_equal(t.assignments(), j.assignments())
    assert t.cluster_mols() == j.cluster_mols()
    np.testing.assert_array_equal(t.cluster_sizes(), j.cluster_sizes())


def test_fit_pool_guard_retry_matches_jax() -> None:
    r"""tests/test_batch_engine.py::test_pool_overflow_guard_grows_and_stays_exact:
    a pool far too small makes rows pend mid-window, so the flush boundary
    grows the pool and retries them (``_retry_scan``)."""
    rng = np.random.default_rng(7)
    base = (rng.random((64, 2048)) < 0.35).astype(np.uint8)
    fps = np.repeat(base, 8, axis=0)[rng.permutation(512)]
    kw = dict(threshold=0.3, batch_size=64, initial_capacity=1024, ls_capacity=8)
    j = jb.BatchTree(2048, **kw)
    j.insert_fps(fps, range(len(fps)))
    t = tb.BatchTree(2048, device="cpu", **kw)
    t.insert_fps(fps, range(len(fps)))
    assert t.ls_capacity == j.ls_capacity > 8
    np.testing.assert_array_equal(t.assignments(), j.assignments())
    assert t.cluster_mols() == j.cluster_mols()


def test_device_resident_input_matches_host_input() -> None:
    r"""A torch tensor input is sliced where it lies (with the tail staged
    into a window buffer); labels equal the host-staged path's."""
    fps = make_fake_fingerprints(2500, seed=SEED)
    host = tb.BatchTree(2048, device="cpu", **CFG_C)
    host.fit_packed(fps, range(len(fps)))
    dev = tb.BatchTree(2048, device="cpu", **CFG_C)
    dev.fit_packed(torch.from_numpy(fps), range(len(fps)))
    np.testing.assert_array_equal(dev.assignments(), host.assignments())


def test_cuda_device_raises_without_cuda(monkeypatch) -> None:
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        tb.BatchTree(2048, device="cuda")
