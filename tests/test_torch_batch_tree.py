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


# -- the refine's handoff on the device against the host path it replaced --


def _handoff_by_host(tree, kind, X=None, n_largest=0, shuffle=False, **kw):
    r"""A refine (``kind`` "refine") or a recluster as the port ran them
    before the handoff moved to the device: dense sums and member lists on
    the host, an int64 buffer array, the public ``insert_buffers``."""
    sizes = tree.cluster_sizes()
    ls = tree.linear_sums()
    mols = tree.cluster_mols()
    if kind == "refine":
        order = np.argsort(-sizes, kind="stable")
        big, rest = order[:n_largest], order[n_largest:]
        exploded = [m for i in big for m in mols[i]]
        tree.reset(**kw)
    else:
        rng = np.random.default_rng(kw.pop("seed", None))
        rest = rng.permutation(len(sizes)) if shuffle else np.argsort(-sizes, kind="stable")
        exploded = []
        tree.reset(threshold=tree.threshold)
    buffers = np.concatenate([ls[rest], sizes[rest, None]], axis=1, dtype=np.int64)
    tree.insert_buffers(buffers, [mols[i] for i in rest])
    rows, row_mols = tb._load_rows_by_mol(X, exploded, 0, True) if exploded else ([], [])
    if len(rows):
        tree.fit_packed(rows, row_mols)


def _pooled_single_tree(packed, n_features, **kw):
    r"""A fitted tree in which five singletons hold pool rows of twice
    their bits, set by hand: a count of 1 whose sums only ``ls_ref`` finds
    (the tile keeps the bits)."""
    tree = tb.BatchTree(n_features, device="cpu", **kw)
    tree.fit_packed(packed, range(len(packed)))
    st = tree.state
    singles = torch.nonzero(st.n[: tree.num_clusters] == 1)[:5, 0]
    rows = int(st.num_ls) + torch.arange(len(singles), dtype=torch.int32)
    assert len(singles) == 5 and int(rows[-1]) < st.ls.shape[0] - 1
    st.ls[rows.long()] = 2 * tb._cluster_ls_of(st, singles, n_features)
    st.ls_ref[singles] = rows
    st.num_ls.add_(len(singles))
    return tree


HANDOFF_CASES = {
    "refine-0": dict(kind="refine", n_largest=0, merge_criterion="diameter"),
    "refine-1": dict(kind="refine", n_largest=1, merge_criterion="diameter"),
    "refine-3-tolerance": dict(kind="refine", n_largest=3, merge_criterion="tolerance-diameter",
                               tolerance=0.05, threshold=0.35),
    "recluster": dict(kind="recluster"),
    "recluster-shuffled": dict(kind="recluster", shuffle=True, seed=7),
    "pooled-single-refine": dict(kind="refine", n_largest=2, merge_criterion="diameter",
                                 pooled_single=True),
    "pooled-single-recluster": dict(kind="recluster", shuffle=True, seed=3,
                                    pooled_single=True),
}


@pytest.mark.parametrize("case", list(HANDOFF_CASES))
def test_the_device_handoff_equals_the_host_path(case) -> None:
    r"""``refine_inplace`` and ``recluster_inplace`` (survivors gathered on
    the device, members as one flat id array) give the labels, members,
    sums, counts and tables of the host path they replaced, bit for bit,
    with survivor counts that leave a part batch (batch 64), on 256-bit
    rows."""
    from bblean_tpu_torch.engine.state_io import state_to_numpy

    kw = dict(HANDOFF_CASES[case])
    kind, pooled_single = kw.pop("kind"), kw.pop("pooled_single", False)
    fps = make_fake_fingerprints(400, seed=SEED, pack=False)[:, :256]
    packed = np.packbits(fps, axis=-1)
    cfg = dict(threshold=0.3, batch_size=64, initial_capacity=512, route_block=64)
    if pooled_single:
        trees = [_pooled_single_tree(packed, 256, **cfg) for _ in range(2)]
    else:
        trees = [tb.BatchTree(256, device="cpu", **cfg) for _ in range(2)]
        for tree in trees:
            tree.fit_packed(packed, range(len(packed)))
    device, host = trees
    n_clusters = device.num_clusters
    assert n_clusters > 64 and n_clusters % 64
    if kind == "refine":
        device.refine_inplace(packed, **kw)
        _handoff_by_host(host, "refine", X=packed, **kw)
    else:
        device.recluster_inplace(**kw)
        _handoff_by_host(host, "recluster", **kw)
    np.testing.assert_array_equal(device.assignments(), host.assignments())
    assert device.cluster_mols() == host.cluster_mols()
    np.testing.assert_array_equal(device.linear_sums(), host.linear_sums())
    np.testing.assert_array_equal(device.cluster_sizes(), host.cluster_sizes())
    a, b = state_to_numpy(device.state), state_to_numpy(host.state)
    for f in a:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    if not pooled_single:
        _assert_sums_are_members(device, fps)


def test_cluster_mols_is_the_flat_members_split() -> None:
    fps = make_fake_fingerprints(300, seed=SEED)
    tree = tb.BatchTree(2048, threshold=0.3, device="cpu", **CFG_A)
    tree.fit_packed(fps, range(len(fps)))
    flat, bounds = tree._cluster_members()
    mols = tree.cluster_mols()
    assert len(bounds) == tree.num_clusters + 1 and bounds[-1] == len(flat) == 300
    assert [flat[bounds[i] : bounds[i + 1]].tolist() for i in range(len(mols))] == mols
    empty = tb.BatchTree(2048, device="cpu", **CFG_A)
    assert empty.cluster_mols() == [] and len(empty._cluster_members()[1]) == 1
