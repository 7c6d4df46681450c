r"""The sharded merge's device functions vs the JAX engine's, on states
captured from inside a JAX merge.

An 8-shard JAX fit (the parameters of ``tests/test_sharded.py``, so that JAX
runs the programs it compiled for that file) is merged round by round
through the forest's own programs.  Each round's stacked states go through
numpy (``engine/state_io.py``) into the port's list of shards, and the
port's ``_best_group_sim``, ``_merge_into_impl`` and ``_insert_slots_impl``
must give JAX's tables and assignment maps EQUAL, table for table (f32
similarities bit for bit), for the forest's own gate and for gates that send
every received group far and every group close.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bblean_tpu.engine import batch as jb
from bblean_tpu.fingerprints import make_fake_fingerprints
from bblean_tpu.parallel import ShardedForest as JaxForest
from bblean_tpu.parallel import get_mesh as jax_mesh
from bblean_tpu.parallel import sharded as js
from bblean_tpu_torch.engine.state_io import (
    state_to_numpy,
    states_from_stacked,
    states_to_stacked,
)
from bblean_tpu_torch.parallel import ShardedForest, get_mesh
from bblean_tpu_torch.parallel import sharded as ts

torch.set_num_threads(2)

SEED = 12620509540149709235

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs >= 8 devices (virtual CPU mesh)"
)


@pytest.fixture(scope="module")
def packed():
    return make_fake_fingerprints(600, seed=SEED)


def _jax_np(state) -> dict:
    return {f: np.array(getattr(state, f)) for f in jb.BatchState._fields}


def _jax_put(forest, arrays: dict):
    return jax.device_put(
        jb.BatchState(**{f: jnp.asarray(v) for f, v in arrays.items()}),
        forest._sharding,
    )


@pytest.fixture(scope="module")
def merge_rounds(packed):
    r"""The merge of an 8-shard JAX fit, run round by round through the
    forest's own programs: per round the states before, the exchanged
    states, the gate, and the states and maps after, for the forest's gate
    and for gates that send every group far and every group close."""
    forest = JaxForest(
        2048, jax_mesh(8), threshold=0.65, batch_size=128, scan_batches=1,
        initial_capacity=2 * 128 + 2, g_capacity=256, route_block=128,
        max_rounds=16,
    )
    forest.fit_packed(packed)
    forest.flush()
    forest._split_drain(drain=True)
    m_b, d = forest.batch_size, forest.n_devices
    own_gate = float(np.clip(forest.merge_threshold - forest.merge_gate_margin, 0, 1))
    rounds = []
    for r in range(math.ceil(math.log2(d))):
        stride = 1 << r
        receivers = [s - stride for s in range(d) if s % (2 * stride) == stride]
        nums = np.asarray(forest.state.num)
        gnums = np.asarray(forest.state.g_num)
        pnums = np.asarray(forest.state.num_ls)
        forest._num_upper = max(int(nums[i] + nums[i + stride]) for i in receivers)
        forest._g_upper = max(
            int(gnums[i] + gnums[i + stride] + nums[i + stride] // forest.tile
                + forest.split_k + 16)
            for i in receivers
        )
        forest._ls_upper = max(
            int(pnums[i] + pnums[i + stride] + nums[i + stride]) for i in receivers
        )
        forest._ensure_capacity(m_b + 1)
        recv = forest._exchange_program(forest.state, stride=stride)
        before, recv_np = _jax_np(forest.state), _jax_np(recv)
        after = {}
        for name, gate in (("far", 2.0), ("close", -3.0), ("own", own_gate)):
            state = _jax_put(forest, before) if name != "own" else forest.state
            state, amap = forest._merge_program(
                state, recv, jnp.int32(stride), jnp.float32(gate),
                jnp.float32(forest.merge_threshold), jnp.float32(forest.tolerance),
                m_b=m_b, criterion=forest.merge_criterion_merge,
                block=forest.route_block, max_rounds=forest.max_rounds,
                split_k=forest.split_k, fanout=forest.fanout,
            )
            after[name] = (gate, _jax_np(state), np.array(amap))
        forest.state = state
        n_sent = {i: int(nums[i + stride]) for i in receivers}
        assert all((after["own"][2][i, :n] >= 0).all() for i, n in n_sent.items())
        rounds.append(dict(
            stride=stride, receivers=receivers, before=before, recv=recv_np,
            after=after, n_sent=n_sent,
        ))
    return forest, rounds


MERGE_KW = dict(
    m_b=128, criterion="diameter", block=128, max_rounds=16, split_k=64, fanout=192
)


def _assert_tables_equal(ref: dict, got: dict, shard: int) -> None:
    for f in jb.BatchState._fields:
        assert got[f].dtype == ref[f].dtype, f
        np.testing.assert_array_equal(got[f], ref[f][shard], err_msg=f)


def test_stacked_state_round_trips(merge_rounds) -> None:
    _forest, rounds = merge_rounds
    stacked = rounds[0]["before"]
    shards = states_from_stacked(stacked, ["cpu"] * 8)
    assert len(shards) == 8 and shards[3].t_pk.dtype == torch.uint8
    back = states_to_stacked(shards)
    for f in jb.BatchState._fields:
        assert back[f].dtype == stacked[f].dtype, f
        np.testing.assert_array_equal(back[f], stacked[f], err_msg=f)
    with pytest.raises(ValueError, match="8 stacked shards"):
        states_from_stacked(stacked, ["cpu"] * 3)


def _best_sims(q_cent, q_pops, g_cent, g_pops, g_num, block):
    ref = jax.jit(js._best_group_sim, static_argnames=("block",))(
        jnp.asarray(q_cent), jnp.asarray(q_pops), jnp.asarray(g_cent),
        jnp.asarray(g_pops), jnp.int32(g_num), block=block,
    )
    got = ts._best_group_sim(
        torch.from_numpy(q_cent), torch.from_numpy(q_pops),
        torch.from_numpy(g_cent), torch.from_numpy(g_pops), int(g_num), block,
    )
    assert got.dtype == torch.float32
    return got.numpy(), np.asarray(ref)


@pytest.mark.parametrize("rnd", [0, 1, 2])
def test_best_group_sim_matches_jax(merge_rounds, rnd) -> None:
    _forest, rounds = merge_rounds
    cap = rounds[rnd]
    i = cap["receivers"][0]
    own, recv = cap["before"], cap["recv"]
    got, ref = _best_sims(
        recv["g_cent"][i], recv["g_pops"][i], own["g_cent"][i], own["g_pops"][i],
        own["g_num"][i], 1,  # one group per block
    )
    np.testing.assert_array_equal(got, ref)
    assert (got[: int(recv["g_num"][i])] > -1.5).all()


@pytest.mark.parametrize("g_num,block", [(45, 16), (64, 16), (1, 64), (0, 8), (50, 128)])
def test_best_group_sim_blocks_match_jax(g_num, block) -> None:
    r"""Several blocks with a partial last one, a full table, one live
    group, none, and a block wider than the table; dead rows hold bits."""
    rng = np.random.default_rng(g_num * 131 + block)
    q_cent = (rng.random((37, 256)) < 0.2).astype(np.int8)
    g_cent = (rng.random((64, 256)) < 0.2).astype(np.int8)
    g_cent[:5] = q_cent[:5]  # similarity 1 where live
    q_cent[7] = 0  # an empty query: union clamps to 1
    q_pops = q_cent.sum(1).astype(np.int32)
    g_pops = g_cent.sum(1).astype(np.int32)
    got, ref = _best_sims(q_cent, q_pops, g_cent, g_pops, g_num, block)
    np.testing.assert_array_equal(got, ref)
    assert (got == -2.0).all() if g_num == 0 else got[0] == 1.0


@pytest.mark.parametrize("gate_name", ["far", "close", "own"])
@pytest.mark.parametrize("rnd", [0, 1, 2])
def test_merge_into_matches_jax(merge_rounds, rnd, gate_name) -> None:
    r"""One receiver, one sender, every receiver of the round: all state
    tables and the assignment map equal JAX's."""
    _forest, rounds = merge_rounds
    cap = rounds[rnd]
    gate, ref_state, ref_amap = cap["after"][gate_name]
    own = states_from_stacked(cap["before"], ["cpu"] * 8)
    recv = states_from_stacked(cap["recv"], ["cpu"] * 8)
    for i in cap["receivers"]:
        state, amap, info = ts._merge_into_impl(
            own[i], recv[i], torch.tensor(gate, dtype=torch.float32),
            torch.tensor(0.65), torch.tensor(0.05), **MERGE_KW,
        )
        _assert_tables_equal(ref_state, state_to_numpy(state), i)
        np.testing.assert_array_equal(amap.numpy(), ref_amap[i])
        live_groups = int(
            ((np.arange(len(cap["recv"]["g_count"][i])) < cap["recv"]["g_num"][i])
             & (cap["recv"]["g_count"][i] > 0)).sum()
        )
        assert info["far"] + info["close"] == live_groups
        if gate_name == "far":
            assert info["close"] == 0 and info["rows"] == 0
        if gate_name == "close":
            assert info["far"] == 0 and info["rows"] == cap["n_sent"][i]


def test_insert_slots_with_a_partial_last_batch_matches_jax(merge_rounds) -> None:
    r"""With every group gated close nothing is appended, so the merge is
    ``_insert_slots_impl`` on every live received slot: in the second round
    more than one batch of 128 rows, the last batch partly masked."""
    _forest, rounds = merge_rounds
    cap = rounds[1]
    i = cap["receivers"][0]
    n_sent = cap["n_sent"][i]
    assert n_sent > 128 and n_sent % 128
    _gate, ref_state, ref_amap = cap["after"]["close"]
    own = states_from_stacked(cap["before"], ["cpu"] * 8)[i]
    recv = states_from_stacked(cap["recv"], ["cpu"] * 8)[i]
    ins = (torch.arange(recv.n.shape[0]) < recv.num) & (recv.n > 0)
    amap0 = torch.full((recv.n.shape[0],), -1, dtype=torch.int32)
    state, amap, n_ins = ts._insert_slots_impl(
        own, recv, ins, amap0, torch.tensor(0.65), torch.tensor(0.05), **MERGE_KW
    )
    assert n_ins == n_sent
    _assert_tables_equal(ref_state, state_to_numpy(state), i)
    np.testing.assert_array_equal(amap.numpy(), ref_amap[i])
    # A retry of a fully mapped merge inserts nothing
    state, amap2, n_again = ts._merge_retry_impl(
        state, recv, amap, torch.tensor(0.65), torch.tensor(0.05), **MERGE_KW
    )
    assert n_again == 0
    np.testing.assert_array_equal(amap2.numpy(), ref_amap[i])


def test_round_by_round_merge_equals_the_forests_own(merge_rounds, packed) -> None:
    r"""The rounds run by hand above end in the state the port's
    ``merge()`` reaches, with the same per-round maps."""
    jforest, rounds = merge_rounds
    forest = ShardedForest(
        2048, get_mesh(devices=["cpu"] * 8), threshold=0.65, batch_size=128, scan_batches=1,
        initial_capacity=2 * 128 + 2, g_capacity=256, route_block=128,
        max_rounds=16,
    )
    forest.fit_packed(packed)
    forest.merge()
    _assert_tables_equal(_jax_np(jforest.state), state_to_numpy(forest.states[0]), 0)
    assert forest.states[1:] == [None] * 7
    for (stride, maps), cap in zip(forest._round_maps, rounds):
        assert stride == cap["stride"] and sorted(maps) == cap["receivers"]
        for i, amap in maps.items():
            np.testing.assert_array_equal(amap, cap["after"]["own"][2][i])
    for stats, cap in zip(forest.merge_stats, rounds):
        assert stats["retries"] == 0
        assert sum(s["rows"] for s in stats["receivers"].values()) <= sum(
            cap["n_sent"].values()
        )
