r"""The batch step's programs (``bblean_tpu_torch/engine/graphs.py``) on
the CPU: the bodies of the insert rounds and of the split pass read nothing
on the host and copy nothing from it (so they can be captured as CUDA
graphs), and the runner's CPU
path, through its static buffers, gives the same tables, labels and
``enc`` as the JAX engine's ``_batch_step_impl``, step after step, also
when the tables grow between steps (the runner's cache rebuilds).

The pre-state is the port's own fit of 1,024 fingerprints at batch 64 on
tiles of 32 cells (small tables, so that groups fill, overflow and split);
JAX and the port then insert the same batches into copies of it.  The CUDA side (a replayed
round equal to a dispatched one, counts through replays) is in
``tests/test_torch_cuda.py``.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bblean_tpu.engine import batch as jb
from bblean_tpu_torch.engine import batch as tb, graphs
from bblean_tpu_torch.engine.state_io import state_from_numpy, state_to_numpy
from bblean_tpu_torch.fingerprints import make_fake_fingerprints

torch.set_num_threads(2)

SEED = 12620509540149709235
M = 64
N_FIT = 1024
TREE_KW = dict(
    batch_size=M, route_block=M, tile=32, fanout=24, initial_capacity=1024,
    g_capacity=128, stage_windows=2, device="cpu",
)
STEP_KW = dict(criterion="diameter", block=M, max_rounds=24)


@functools.lru_cache(maxsize=None)
def _prestate(threshold: float) -> tuple[np.ndarray, dict]:
    r"""(fingerprints, numpy state after the port fits the first 1,024)."""
    fps = make_fake_fingerprints(N_FIT + 4 * M, seed=SEED)
    tree = tb.BatchTree(2048, threshold=threshold, **TREE_KW)
    tree.fit_packed(fps[:N_FIT], range(N_FIT))
    return fps, state_to_numpy(tree.state)


def _rows(fps: np.ndarray, i: int):
    packed = fps[N_FIT + i * M : N_FIT + (i + 1) * M]
    valid = np.ones(M, bool)
    valid[-3 - i :] = False  # padding rows
    jrows = jb._prep_fp_rows(jnp.asarray(packed), jnp.asarray(valid), 2048)
    trows = tb._prep_fp_rows(torch.from_numpy(packed), torch.from_numpy(valid), 2048)
    return jrows, trows


def _jax_state(arrays: dict):
    return jb.BatchState(**{f: jnp.asarray(v) for f, v in arrays.items()})


def _assert_equal(ref: dict, got: dict) -> None:
    for f in jb.BatchState._fields:
        assert got[f].dtype == ref[f].dtype, f
        np.testing.assert_array_equal(got[f], ref[f], err_msg=f)


def test_round_and_split_bodies_read_nothing_on_the_host(monkeypatch) -> None:
    r"""A wide round on the sorted plan, a narrow round and the split pass,
    with every tensor-to-host read and every tensor made from host data
    refused."""
    fps, state = _prestate(0.3)
    _jrows, trows = _rows(fps, 0)
    tstate = state_from_numpy(state, "cpu")
    thr, tol = torch.tensor(0.3), torch.tensor(0.05)
    bufs = tb._stage_step(tstate, *trows, thr, tol, block=M)
    tables = tb._tables(tstate)
    counts = state["g_count"][: int(state["g_num"])]
    fanout = int(np.sort(counts)[-3])

    def refuse(*args, **kwargs):
        raise AssertionError("a host read inside a graphed program")

    def refuse_copy(*args, **kwargs):
        raise AssertionError("a tensor copied from the host inside a graphed program")

    with monkeypatch.context() as mp:
        for name in ("item", "__bool__", "__int__", "tolist", "numpy", "cpu"):
            mp.setattr(torch.Tensor, name, refuse)
        for name in ("tensor", "as_tensor", "from_numpy"):
            mp.setattr(torch, name, refuse_copy)
        wide = tb._wide_round(tables, bufs, criterion="diameter")
        tb._carry(bufs, wide)
        narrow = tb._narrow_round(tables, bufs, criterion="diameter", narrow=M // 4)
        tb._carry(bufs, narrow)
        _split_state, n_left = tb._split_topk_impl(tstate, k=8, fanout=fanout)
    assert [t.shape for t in wide] == [(M,)] * 3 + [()] * 3
    assert [t.shape for t in narrow] == [(M,)] * 3 + [()] * 3
    assert int(n_left) >= 0
    with pytest.raises(AssertionError, match="host read"):
        with monkeypatch.context() as mp:
            mp.setattr(torch.Tensor, "__bool__", refuse)
            bool(bufs["pending"].any())


@pytest.mark.parametrize("narrow", [0, M // 4])
@pytest.mark.parametrize("threshold", [0.3, 0.65])
def test_runner_steps_equal_jax(threshold, narrow) -> None:
    r"""Four steps in a row: the first use of each program runs it
    dispatched, the second captures it, the rest replay it (on the CPU:
    call it through the same buffers)."""
    fps, state = _prestate(threshold)
    jthr, jtol = jnp.float32(threshold), jnp.float32(0.05)
    tthr, ttol = torch.tensor(threshold), torch.tensor(0.05)
    jstate, tstate = _jax_state(state), state_from_numpy(state, "cpu")
    before = (graphs.warmups, graphs.captures, graphs.replays)
    for i in range(4):
        jrows, trows = _rows(fps, i)
        jstate, jassigned, jenc = jb._batch_step(
            jstate, *jrows, jthr, jtol, use_pallas=False, narrow=narrow, **STEP_KW
        )
        tstate, tassigned, tenc = tb._batch_step_impl(
            tstate, *trows, tthr, ttol, narrow=narrow, **STEP_KW
        )
        _assert_equal({f: np.asarray(getattr(jstate, f)) for f in jb.BatchState._fields},
                      state_to_numpy(tstate))
        np.testing.assert_array_equal(tassigned.numpy(), np.asarray(jassigned))
        assert int(tenc) == int(jenc)
    warm, cap, rep = (a - b for a, b in zip((graphs.warmups, graphs.captures, graphs.replays), before))
    assert warm >= 1 and cap >= 1 and rep >= 1, (warm, cap, rep)


def test_runner_rebuilds_after_the_tables_grow() -> None:
    r"""Grow the cluster table and the pool between steps (as
    ``BatchTree._ensure_capacity`` does): the next step's programs are new
    keys, warmed and captured again, and the old ones are dropped once
    their tables are freed; JAX on the grown state agrees."""
    fps, state = _prestate(0.3)
    jthr, jtol = jnp.float32(0.3), jnp.float32(0.05)
    tthr, ttol = torch.tensor(0.3), torch.tensor(0.05)
    jstate, tstate = _jax_state(state), state_from_numpy(state, "cpu")
    kw = dict(narrow=M // 4, **STEP_KW)

    def step(i):
        nonlocal jstate, tstate
        jrows, trows = _rows(fps, i)
        jstate, jassigned, jenc = jb._batch_step(jstate, *jrows, jthr, jtol, use_pallas=False, **kw)
        tstate, tassigned, tenc = tb._batch_step_impl(tstate, *trows, tthr, ttol, **kw)
        _assert_equal({f: np.asarray(getattr(jstate, f)) for f in jb.BatchState._fields},
                      state_to_numpy(tstate))
        np.testing.assert_array_equal(tassigned.numpy(), np.asarray(jassigned))
        assert int(tenc) == int(jenc)

    def keyed_on(st):
        ptrs = {t.data_ptr() for t in tb._tables(st)}
        return [k for k in graphs._programs if {p for p, _s, _d in k[1]} <= ptrs]

    step(0)
    step(1)
    old = keyed_on(tstate)
    assert old and all(graphs._programs[k].captured for k in old if k[0][0] == "wide")
    warm = graphs.warmups
    new_c, new_p = 2 * tstate.n.shape[0], 2 * tstate.ls.shape[0]
    g_cap = tstate.g_ls.shape[0]
    jstate = jb._grow_state(jstate, new_c, g_cap, new_p)
    tstate = tb._grow_state(tstate, new_c, g_cap, new_p)
    assert not any(k in graphs._programs for k in old)  # the old tables were freed
    step(2)
    step(3)
    assert graphs.warmups > warm
    grown = keyed_on(tstate)
    assert grown and not set(grown) & set(old)
    assert all(graphs._programs[k].captured for k in grown if k[0][0] == "wide")
