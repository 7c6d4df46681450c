r"""``ShardedForest`` of the port vs the JAX engine's, method by method.

JAX runs on its 8 virtual CPU devices, the port on a mesh that names the
CPU as many times.  The constructor parameters are those of
``tests/test_sharded.py``, so that JAX runs the programs it compiled for
that file.  Everything compared is integer-valued or an f32 that must be
bit-equal, so every comparison is exact: cluster labels (raw slot ids, and
under the first-occurrence canon), sizes and linear sums.  ``sharded_fit``
is held to JAX in ``tests/test_torch_sharded.py``, the merge's device
functions in ``tests/test_torch_sharded_merge.py``.
"""

import numpy as np
import pytest
import torch

import jax

from bblean_tpu.fingerprints import make_fake_fingerprints
from bblean_tpu.parallel import ShardedForest as JaxForest
from bblean_tpu.parallel import get_mesh as jax_mesh
from bblean_tpu_torch.parallel import (
    Mesh,
    ShardedForest,
    get_mesh,
)
from bblean_tpu_torch.parallel import sharded as ts

torch.set_num_threads(2)

SEED = 12620509540149709235

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs >= 8 devices (virtual CPU mesh)"
)


def cpu_mesh(n: int) -> Mesh:
    return get_mesh(devices=["cpu"] * n)


def canon(labels: np.ndarray) -> np.ndarray:
    r"""Relabel by first occurrence."""
    _u, first, inv = np.unique(labels, return_index=True, return_inverse=True)
    return np.argsort(np.argsort(first))[inv]


def assert_same_clusters(got, ref) -> None:
    r"""Labels (raw and canonical), sizes and linear sums of two results."""
    np.testing.assert_array_equal(canon(got.labels), canon(ref.labels))
    np.testing.assert_array_equal(got.labels, ref.labels)
    np.testing.assert_array_equal(got.sizes, ref.sizes)
    np.testing.assert_array_equal(got.linear_sums, ref.linear_sums)
    assert got.num_clusters == ref.num_clusters == len(got.sizes)


def forest_result(forest):
    return ts.ShardedClusters(
        labels=forest.labels(), linear_sums=forest.linear_sums(),
        sizes=forest.cluster_sizes(), num_clusters=forest.num_clusters,
    )


@pytest.fixture(scope="module")
def fps():
    return make_fake_fingerprints(600, seed=SEED, pack=False)


@pytest.fixture(scope="module")
def packed(fps):
    return np.packbits(fps, axis=-1)


FOREST_KW = dict(threshold=0.3, batch_size=128, route_block=128, scan_batches=2)


def test_streamed_chunked_and_tensor_input_match_resident_and_jax() -> None:
    rows = make_fake_fingerprints(2500, seed=SEED)
    kw = dict(FOREST_KW, stage_windows=2)

    def fit(cls, mesh, data, **extra):
        forest = cls(2048, mesh, **kw, **extra)
        forest.fit_packed(data)
        forest.merge()
        return forest.labels()

    # window = 4*2*128 = 1024 rows -> 3 windows; resident holds all 3,
    # streamed runs 2-window chunks (one full chunk + a padded partial)
    ref = fit(JaxForest, jax_mesh(4), rows)
    resident = fit(ShardedForest, cpu_mesh(4), rows)
    streamed = fit(ShardedForest, cpu_mesh(4), rows, resident_input_bytes=0)
    tensor = fit(
        ShardedForest, cpu_mesh(4), torch.from_numpy(rows), resident_input_bytes=0
    )
    np.testing.assert_array_equal(resident, ref)
    np.testing.assert_array_equal(streamed, ref)
    np.testing.assert_array_equal(tensor, ref)


def test_pipeline_depth_invariant_and_equal_to_jax(packed) -> None:
    kw = dict(threshold=0.65, batch_size=64, route_block=128, scan_batches=2)
    results = []
    for depth in (1, 3):
        forest = ShardedForest(2048, cpu_mesh(4), pipeline_depth=depth, **kw)
        forest.fit_packed(packed)
        results.append(forest.labels())
    ref = JaxForest(2048, jax_mesh(4), pipeline_depth=3, **kw)
    ref.fit_packed(packed)
    np.testing.assert_array_equal(results[0], results[1])
    np.testing.assert_array_equal(results[1], ref.labels())


def test_capacity_decoupled_from_input_size_equals_jax() -> None:
    base = make_fake_fingerprints(64, seed=3, pack=False)
    rows = np.packbits(np.repeat(base, 48, axis=0), axis=-1)  # 3072 rows
    kw = dict(
        threshold=0.3, batch_size=128, initial_capacity=512, route_block=128,
        scan_batches=2,
    )
    ref = JaxForest(2048, jax_mesh(8), **kw)
    got = ShardedForest(2048, cpu_mesh(8), **kw)
    for forest in (ref, got):
        forest.fit_packed(rows)
        forest.merge()
    assert_same_clusters(forest_result(got), forest_result(ref))
    assert got.cluster_sizes().sum() == 3072
    assert got.capacity == ref.capacity <= 1024
    assert (got.g_capacity, got.ls_capacity) == (ref.g_capacity, ref.ls_capacity)
    assert got.state_bytes_per_device() == ref.state_bytes_per_device()


def test_refine_inplace_equals_jax(packed) -> None:
    ref = JaxForest(2048, jax_mesh(4), **FOREST_KW)
    got = ShardedForest(2048, cpu_mesh(4), **FOREST_KW)
    for forest in (ref, got):
        forest.fit_packed(packed)
        forest.merge()
    labels0 = got.labels()
    np.testing.assert_array_equal(labels0, ref.labels())
    for forest in (ref, got):
        forest.refine_inplace(packed, n_largest=2, threshold=0.35)
    assert_same_clusters(forest_result(got), forest_result(ref))
    labels = got.labels()
    assert labels.shape == (600,) and (labels >= 0).all()
    assert got.cluster_sizes().sum() == 600
    with pytest.raises(RuntimeError, match="cannot insert after merge"):
        got.fit_packed(packed)
    with pytest.raises(ValueError, match="n_largest"):
        got.refine_inplace(packed, n_largest=-1)


def test_insert_buffers_equals_jax() -> None:
    rng = np.random.default_rng(5)
    ls = rng.integers(0, 6, size=(300, 2048), dtype=np.int64)
    ns = np.maximum(ls.max(axis=1), 1).astype(np.int64)
    buffers = np.concatenate([ls, ns[:, None]], axis=1)
    mol_seqs = [[i] for i in range(300)]
    ref = JaxForest(2048, jax_mesh(4), **FOREST_KW)
    got = ShardedForest(2048, cpu_mesh(4), **FOREST_KW)
    for forest in (ref, got):
        forest.insert_buffers(buffers, mol_seqs)
        forest.merge()
    assert_same_clusters(forest_result(got), forest_result(ref))
    assert got.cluster_sizes().sum() == ns.sum()
    assert got.cluster_mols() == ref.cluster_mols()


def test_recluster_inplace_equals_jax(packed) -> None:
    ref = JaxForest(2048, jax_mesh(4), **FOREST_KW)
    got = ShardedForest(2048, cpu_mesh(4), **FOREST_KW)
    for forest in (ref, got):
        forest.fit_packed(packed)
    n_before = got.num_clusters
    for forest in (ref, got):
        forest.recluster_inplace()
    assert_same_clusters(forest_result(got), forest_result(ref))
    assert got.num_clusters <= n_before


def test_refine_applies_threshold_change_once(packed) -> None:
    kw = dict(
        threshold=0.65, merge_threshold_change=-0.1, batch_size=128,
        route_block=128, scan_batches=2,
    )
    ref = JaxForest(2048, jax_mesh(2), **kw)
    got = ShardedForest(2048, cpu_mesh(2), **kw)
    for forest in (ref, got):
        forest.fit_packed(packed)
        forest.refine_inplace(
            packed, n_largest=1, threshold=0.65 - 0.1, merge_threshold_change=0.0
        )
    assert got.threshold == pytest.approx(0.55)
    assert got.merge_threshold == pytest.approx(0.55)  # not 0.45
    assert_same_clusters(forest_result(got), forest_result(ref))


def test_mol_indices_length_mismatch_raises(packed) -> None:
    forest = ShardedForest(2048, cpu_mesh(2), threshold=0.65, **{
        k: v for k, v in FOREST_KW.items() if k != "threshold"
    })
    with pytest.raises(ValueError, match="misalign"):
        forest.fit_packed(packed, np.arange(len(packed) - 5))
    with pytest.raises(ValueError, match="packed rows have 64 bytes"):
        forest.fit_packed(packed[:, :64])


def test_warm_programs_changes_no_label(packed) -> None:
    cold = ShardedForest(2048, cpu_mesh(4), **FOREST_KW)
    warm = ShardedForest(2048, cpu_mesh(4), **FOREST_KW)
    warm.warm_programs(packed)
    for forest in (cold, warm):
        forest.fit_packed(packed)
    np.testing.assert_array_equal(warm.labels(), cold.labels())
    assert len(warm.merge_stats) == 2 and warm.merge_stats[0]["stride"] == 1
    sent = sum(
        s["far"] + s["close"]
        for rnd in warm.merge_stats for s in rnd["receivers"].values()
    )
    assert sent > 0


def test_merge_reserves_what_the_pair_needs() -> None:
    r"""Two shards of ~150 clusters in tables of 256 slots: the merged pair
    needs ~300.  ``_ensure_capacity`` alone re-reads the counters, finds
    150 + a batch within 256 and grows nothing (where the JAX engine stops,
    and drops the appended slots that do not fit); the port reserves the
    pair's need before the append, so every cluster lands."""
    rows = make_fake_fingerprints(300, seed=SEED)
    forest = ShardedForest(
        2048, cpu_mesh(2), threshold=0.65, batch_size=32, scan_batches=5,
        initial_capacity=200, route_block=128, merge_gate_margin=0.0,
    )
    forest.fit_packed(rows)
    assert forest.capacity == 256
    before = forest._counters()[:, 0]
    assert before.max() + 32 + 2 <= 256 < before.sum() + 1
    forest.merge()
    assert forest.capacity == 512 and forest.merge_stats[0]["growths"] == 1
    labels, sizes = forest.labels(), forest.cluster_sizes()
    assert forest.num_clusters > 256 and sizes.sum() == 300
    np.testing.assert_array_equal(np.bincount(labels, minlength=len(sizes)), sizes)
    single = sharded_like_one_shard(rows)
    assert abs(forest.num_clusters - single) <= 0.05 * single


def sharded_like_one_shard(rows) -> int:
    forest = ShardedForest(
        2048, cpu_mesh(1), threshold=0.65, batch_size=32, scan_batches=5,
        route_block=128,
    )
    forest.fit_packed(rows)
    return forest.num_clusters
