r"""The port's ``BatchTree`` beyond the fit path vs the JAX ``BatchTree``.

Buffer insertion, refinement (from an array and from an ``.npy`` file),
reclustering, ``reset``, extraction (``linear_sums``,
``packed_centroids``, ``pool_dead_rows``), ``predict_packed`` and
``warm_programs``, on the configurations of ``tests/test_batch_engine.py``
and ``tests/test_pool_telemetry.py`` (so that JAX compiles the programs
those tests compile).  Labels, ``cluster_mols``, linear sums, centroids,
dead-row counts, predicted slots and sims (bit for bit) must be EQUAL to
JAX's on the CPU.
"""

import numpy as np
import pytest
import torch

from bblean_tpu.engine import batch as jb
from bblean_tpu.fingerprints import make_fake_fingerprints
from bblean_tpu_torch.engine import batch as tb
from bblean_tpu_torch.engine.state_io import state_to_numpy

torch.set_num_threads(2)

SEED = 12620509540149709235
# tests/test_batch_engine.py::_fit_batch
CFG_A = dict(batch_size=256, initial_capacity=1024, route_block=512)


def _both(n_features=2048, **kw):
    return jb.BatchTree(n_features, **kw), tb.BatchTree(n_features, device="cpu", **kw)


def _fit_both(fps_unpacked, threshold, **kw):
    kw = {**CFG_A, **kw}
    j, t = _both(fps_unpacked.shape[1], threshold=threshold, **kw)
    for tree in (j, t):
        tree.insert_fps(fps_unpacked, range(len(fps_unpacked)))
    return j, t


def _assert_trees_equal(j, t) -> None:
    assert t.num_clusters == j.num_clusters
    np.testing.assert_array_equal(t.assignments(), j.assignments())
    assert t.cluster_mols() == j.cluster_mols()
    np.testing.assert_array_equal(t.cluster_sizes(), j.cluster_sizes())
    ls = t.linear_sums()
    assert ls.dtype == np.int32
    np.testing.assert_array_equal(ls, j.linear_sums())
    np.testing.assert_array_equal(t.packed_centroids(), j.packed_centroids())
    assert t.pool_dead_rows == j.pool_dead_rows


def _assert_sums_are_members(tree, fps_unpacked) -> None:
    for ls, members in zip(tree.linear_sums(), tree.cluster_mols()):
        np.testing.assert_array_equal(ls, fps_unpacked[members].sum(0))


def test_insert_buffers_matches_jax() -> None:
    r"""test_batch_engine.py::test_buffer_mode_merge: one tree's CF buffers
    re-inserted into a fresh tree."""
    fps = make_fake_fingerprints(300, seed=SEED, pack=False)
    j1, t1 = _fit_both(fps, 0.3)
    _assert_trees_equal(j1, t1)
    bufs = np.concatenate([t1.linear_sums(), t1.cluster_sizes()[:, None]], axis=1)
    mols = t1.cluster_mols()
    kw = dict(threshold=0.3, batch_size=128, initial_capacity=512, route_block=128)
    j2, t2 = _both(**kw)
    j2.insert_buffers(bufs, mols)
    t2.insert_buffers(bufs, mols)
    _assert_trees_equal(j2, t2)
    assert t2.num_clusters <= t1.num_clusters
    _assert_sums_are_members(t2, fps)


def test_mixed_fps_then_buffers_matches_jax() -> None:
    fps = make_fake_fingerprints(100, seed=4, pack=False)
    bufs = np.concatenate([fps[50:].astype(np.int64), np.ones((50, 1), np.int64)], axis=1)
    j, t = _both(threshold=0.3, batch_size=64, initial_capacity=512, route_block=64)
    for tree in (j, t):
        tree.insert_fps(fps[:50], range(50))
        tree.insert_buffers(bufs, [[50 + i] for i in range(50)])
    _assert_trees_equal(j, t)
    assert sorted(i for c in t.cluster_mols() for i in c) == list(range(100))


def test_refine_inplace_from_array_matches_jax() -> None:
    fps = make_fake_fingerprints(400, seed=SEED, pack=False)
    j, t = _fit_both(fps, 0.3)
    packed = np.packbits(fps, axis=-1)
    for tree in (j, t):
        tree.refine_inplace(packed, n_largest=1, merge_criterion="never-merge")
    _assert_trees_equal(j, t)
    assert t.merge_criterion == "never-merge"
    _assert_sums_are_members(t, fps)


def test_refine_inplace_from_file_matches_jax(tmp_path) -> None:
    fps = make_fake_fingerprints(300, seed=SEED, pack=False)
    p = tmp_path / "fps.npy"
    np.save(p, np.packbits(fps, axis=-1))
    j, t = _fit_both(fps, 0.3)
    for tree in (j, t):
        tree.refine_inplace(p, n_largest=2, merge_criterion="tolerance-diameter")
    _assert_trees_equal(j, t)
    _assert_sums_are_members(t, fps)


def test_recluster_inplace_matches_jax() -> None:
    fps = make_fake_fingerprints(300, seed=SEED, pack=False)
    j, t = _fit_both(fps, 0.3)
    n_before = t.num_clusters
    for tree in (j, t):
        tree.recluster_inplace(shuffle=True, seed=7)
    _assert_trees_equal(j, t)
    assert t.num_clusters <= n_before
    _assert_sums_are_members(t, fps)


def test_reset_with_new_criterion_matches_jax() -> None:
    fps = make_fake_fingerprints(200, seed=SEED, pack=False)
    j, t = _fit_both(fps, 0.3)
    for tree in (j, t):
        tree.reset(threshold=0.5, merge_criterion="radius", tolerance=0.1)
        assert tree.num_clusters == 0 and tree.assignments().shape == (0,)
        tree.insert_fps(fps, range(len(fps)))
    assert (t.threshold, t.merge_criterion, t.tolerance) == (0.5, "radius", 0.1)
    _assert_trees_equal(j, t)


@pytest.fixture(scope="module")
def predict_trees():
    r"""test_batch_engine.py::test_predict_packed_matches_bruteforce's tree
    and queries."""
    rng = np.random.default_rng(11)
    protos = (rng.random((6, 2048)) < 0.5).astype(np.uint8)
    members = np.repeat(protos, 40, axis=0)
    flips = rng.random(members.shape) < 0.01
    members = np.where(flips, 1 - members, members).astype(np.uint8)
    j, t = _fit_both(members, 0.5, batch_size=64, initial_capacity=512)
    queries = np.where(
        rng.random((32, 2048)) < 0.01, 1 - protos[rng.integers(0, 6, 32)],
        protos[rng.integers(0, 6, 32)],
    ).astype(np.uint8)
    queries[:6] = protos
    rand = make_fake_fingerprints(90, seed=9)  # queries far from every cluster
    return j, t, np.concatenate([np.packbits(queries, axis=-1), rand])


@pytest.mark.parametrize("batch", [64, 60])
def test_predict_packed_matches_jax(predict_trees, batch) -> None:
    r"""batch=64 takes the sorted search, batch=60 the per-row search; both
    equal JAX's slots and sims."""
    from bblean_tpu._np_similarity import _jt_sim_arr_vec_packed

    j, t, q = predict_trees
    t_slots, t_sims = t.predict_packed(q, batch=batch)
    j_slots, j_sims = j.predict_packed(q, batch=batch)
    assert t_slots.dtype == np.int64 and t_sims.dtype == np.float64
    np.testing.assert_array_equal(t_slots, j_slots)
    np.testing.assert_array_equal(t_sims, j_sims)
    assert (t_slots >= 0).all() and (t_slots < t.num_clusters).all()
    cents = t.packed_centroids()
    for qi, slot, sim in zip(q[:32], t_slots, t_sims):
        all_sims = _jt_sim_arr_vec_packed(cents, qi)
        np.testing.assert_allclose(sim, all_sims[slot], atol=1e-6)
        np.testing.assert_allclose(sim, all_sims.max(), atol=1e-6)


def test_predict_on_an_empty_tree_matches_jax() -> None:
    q = make_fake_fingerprints(7, seed=9)
    j, t = _both(threshold=0.3, **CFG_A)
    j_slots, j_sims = j.predict_packed(q, batch=64)
    t_slots, t_sims = t.predict_packed(q, batch=64)
    np.testing.assert_array_equal(t_slots, j_slots)
    np.testing.assert_array_equal(t_sims, j_sims)
    assert (t_slots == -1).all()


def test_warm_programs_leaves_the_state_unchanged() -> None:
    fps = make_fake_fingerprints(300, seed=SEED)
    t = tb.BatchTree(2048, threshold=0.3, device="cpu", **CFG_A)
    t.fit_packed(fps, range(len(fps)))
    before = state_to_numpy(t.state)
    labels = t.assignments()
    pad = np.zeros((t.scan_batches * t.batch_size, fps.shape[1]), np.uint8)
    t.warm_programs(pad)
    after = state_to_numpy(t.state)
    for f in before:
        np.testing.assert_array_equal(after[f], before[f], err_msg=f)
    np.testing.assert_array_equal(t.assignments(), labels)


def _paired_fps(n_distinct: int, seed: int = 7) -> np.ndarray:
    r"""test_pool_telemetry.py::_paired_fps."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, size=(n_distinct, 256), dtype=np.uint8)
    return np.repeat(base, 2, axis=0)


def test_pool_dead_rows_zero_on_clean_run_matches_jax() -> None:
    fps = _paired_fps(512)
    j, t = _both(threshold=0.99, batch_size=256)
    for tree in (j, t):
        tree.fit_packed(fps, range(len(fps)))
    assert t.num_clusters == 512
    assert t.pool_dead_rows == j.pool_dead_rows == 0
    np.testing.assert_array_equal(t.assignments(), j.assignments())


def test_pool_leak_and_recluster_match_jax() -> None:
    r"""test_pool_telemetry.py::test_pool_leak_counted_on_group_kill_path,
    cut from 8,192 pairs in batches of 1,024 to 2,048 pairs in batches of
    256: a group table far too small kills creations after their pool refs
    were taken, and the dead count and the labels, before and after a
    recluster, equal JAX's.  At the full size JAX's split passes open
    groups past its table (its gathers then read clamped rows), where the
    port's splits wait for the table to grow, and the labels part:
    ``tests/test_torch_pool_telemetry.py`` shows the JAX fault there and
    holds the port to its own invariants."""
    n_distinct = 2048
    fps = _paired_fps(n_distinct)
    j, t = _both(
        threshold=0.99, batch_size=256, fanout=48, tile=64, g_capacity=64,
        initial_capacity=1 << 14, ls_capacity=1 << 14,
    )
    for tree in (j, t):
        tree._scan_g_headroom = lambda: 0  # in-window creations hit the guard
        tree.fit_packed(fps, range(len(fps)))
    assert t.num_clusters == n_distinct
    assert (t.cluster_sizes() == 2).all()
    dead = t.pool_dead_rows
    assert 0 < dead <= int(t.state.num_ls) and dead == j.pool_dead_rows
    np.testing.assert_array_equal(t.assignments(), j.assignments())
    for tree in (j, t):
        tree.recluster_inplace()
    assert t.pool_dead_rows == j.pool_dead_rows
    np.testing.assert_array_equal(t.assignments(), j.assignments())
    assert t.cluster_mols() == j.cluster_mols()
