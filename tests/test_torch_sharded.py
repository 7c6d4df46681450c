r"""The port's sharded engine vs the JAX engine, unit by unit and whole.

JAX runs on its 8 virtual CPU devices, the port on a mesh that names the
CPU as many times.  The constructor parameters are those of
``tests/test_sharded.py``, so that JAX runs the programs it compiled for
that file.  Everything compared is integer-valued or an f32 that must be
bit-equal, so every comparison is exact: cluster labels (raw slot ids, and
under the first-occurrence canon), sizes and linear sums.  The merge's
device functions are held to JAX in ``tests/test_torch_sharded_merge.py``,
the forest's methods in ``tests/test_torch_sharded_forest.py``.
"""

import numpy as np
import pytest
import torch

import jax

from bblean_tpu.fingerprints import make_fake_fingerprints
from bblean_tpu.parallel import get_mesh as jax_mesh
from bblean_tpu.parallel import sharded_fit as jax_sharded_fit
from bblean_tpu_torch import _graft_entry
from bblean_tpu_torch.engine import batch as tb
from bblean_tpu_torch.parallel import (
    Mesh,
    get_mesh,
    sharded_fit,
)

torch.set_num_threads(2)

SEED = 12620509540149709235
FIT_KW = dict(batch_size=128, centroid_block=128, g_capacity=256, max_rounds=16)

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


@pytest.fixture(scope="module")
def fps():
    return make_fake_fingerprints(600, seed=SEED, pack=False)


@pytest.fixture(scope="module")
def packed(fps):
    return np.packbits(fps, axis=-1)


# -- the mesh ---------------------------------------------------------------------


def test_get_mesh_names_one_device_many_times() -> None:
    mesh = cpu_mesh(8)
    assert mesh.size == 8 and set(mesh.devices) == {torch.device("cpu")}
    assert hash(mesh) == hash(cpu_mesh(8)) and mesh == cpu_mesh(8)
    assert get_mesh(device="cpu").size == 1
    assert get_mesh(3, devices=["cpu"] * 8).size == 3


def test_get_mesh_too_many_devices_raises() -> None:
    with pytest.raises(ValueError, match="Requested 9 devices, only 8 visible"):
        get_mesh(9, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="Requested 2 devices, only 1 visible"):
        get_mesh(2, device="cpu")


def test_get_mesh_cuda_without_a_card_raises() -> None:
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is available")
    for kw in ({}, {"device": "cuda"}, {"devices": ["cuda:0"] * 2}):
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            get_mesh(**kw)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        sharded_fit(np.zeros((4, 64), np.uint8))


def test_graft_entry_runs_on_the_cpu() -> None:
    step, args = _graft_entry.entry("cpu")
    assert args[3].dtype == torch.int8  # row_cent, as the engine builds it
    state, assigned, enc = step(*args)
    assert int(enc) // 1000 == 0 and (assigned >= 0).all()
    assert int(state.num) == len(torch.unique(assigned))
    _graft_entry.dryrun_multichip(8, "cpu")


# -- the whole engine ----------------------------------------------------------------


@pytest.mark.parametrize(
    "n_dev,threshold,n_clusters",
    [(8, 0.65, 589), (4, 0.65, None), (1, 0.65, 587), (8, 0.3, 254), (3, 0.65, None)],
    ids=["8-shards", "4-shards", "1-shard", "8-shards-t0.3", "3-shards"],
)
def test_sharded_fit_equals_jax(fps, n_dev, threshold, n_clusters) -> None:
    ref = jax_sharded_fit(fps, jax_mesh(n_dev), threshold=threshold, **FIT_KW)
    got = sharded_fit(fps, cpu_mesh(n_dev), threshold=threshold, **FIT_KW)
    assert_same_clusters(got, ref)
    if n_clusters is not None:
        assert got.num_clusters == n_clusters
    assert got.labels.shape == (600,) and got.labels.min() >= 0
    hist = np.bincount(got.labels, minlength=got.num_clusters)
    np.testing.assert_array_equal(hist, got.sizes)
    # Linear sums equal the members' bits
    for slot in range(0, got.num_clusters, 7):
        members = np.nonzero(got.labels == slot)[0]
        np.testing.assert_array_equal(got.linear_sums[slot], fps[members].sum(0))


def test_merge_round_threshold_change_equals_jax(fps) -> None:
    kw = dict(
        threshold=0.65, merge_threshold_change=-0.35, batch_size=128,
        centroid_block=128, max_rounds=16,
    )
    ref = jax_sharded_fit(fps, jax_mesh(4), **kw)
    got = sharded_fit(fps, cpu_mesh(4), **kw)
    assert_same_clusters(got, ref)
    strict = sharded_fit(fps, cpu_mesh(4), threshold=0.65, **FIT_KW)
    assert got.num_clusters <= strict.num_clusters


def test_single_shard_matches_the_batch_tree(fps) -> None:
    r"""A one-shard mesh runs the scan windows ``BatchTree`` runs."""
    res = sharded_fit(
        fps, cpu_mesh(1), threshold=0.65, batch_size=128, centroid_block=128,
        max_rounds=16,
    )
    tree = tb.BatchTree(
        2048, threshold=0.65, batch_size=128, route_block=128,
        initial_capacity=1024, max_rounds=16, device="cpu",
    )
    tree.insert_fps(fps, range(len(fps)))
    assert res.num_clusters == tree.num_clusters
    assert sorted(res.sizes.tolist()) == sorted(tree.cluster_sizes().tolist())
