r"""The pool-leak configuration of ``tests/test_pool_telemetry.py`` at its
full size (8,192 fingerprint pairs, one window of 16 batches of 1,024, a
64-group table, the window's group headroom disabled), in both engines.

There the JAX engine's split passes open groups past its group table: its
``g_num`` passes ``g_capacity``, the table writes of those groups are
dropped, and after the fit thousands of clusters point at tile cells that
do not hold them.  The port's split passes wait for the host to grow the
table instead (a documented difference of ``bblean_tpu_torch/engine/batch.py``),
so the two engines' labels part at this size and are compared at a smaller
one in ``tests/test_torch_batch_tree.py``.  Here the JAX fault is shown,
and the port is held to its own invariants.
"""

import numpy as np
import torch

from bblean_tpu.engine import batch as jb
from bblean_tpu_torch.engine import batch as tb
from bblean_tpu_torch.engine.state_io import state_to_numpy

torch.set_num_threads(2)

N_DISTINCT = 8192
CFG = dict(
    threshold=0.99, batch_size=1024, fanout=48, tile=64, g_capacity=64,
    initial_capacity=1 << 15, ls_capacity=1 << 15,
)


def _paired_fps(n_distinct: int, seed: int = 7) -> np.ndarray:
    r"""test_pool_telemetry.py::_paired_fps."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, size=(n_distinct, 256), dtype=np.uint8)
    return np.repeat(base, 2, axis=0)


def _fit_recording_groups(tree, fps) -> list[tuple[int, int]]:
    r"""Fit as test_pool_telemetry does; returns (live groups, group table
    size) as the host reads them at every capacity check."""
    tree.scan_batches = 16
    tree._scan_g_headroom = lambda: 0
    seen = []
    ensure = tree._ensure_capacity

    def recording_ensure(*args, **kwargs):
        seen.append((int(tree.state.g_num), tree.g_capacity))
        return ensure(*args, **kwargs)

    tree._ensure_capacity = recording_ensure
    tree.fit_packed(fps, range(len(fps)))
    return seen


def _misplaced_clusters(st: dict) -> int:
    r"""Live clusters whose (group, pos) is not a tile cell holding them."""
    num, g_num = int(st["num"]), int(st["g_num"])
    live = np.flatnonzero(st["n"][:num] > 0)
    grp, pos = st["group"][live], st["pos"][live]
    inside = (grp >= 0) & (grp < g_num) & (pos >= 0) & (pos < st["t_slot"].shape[1])
    held = np.zeros(len(live), bool)
    held[inside] = st["t_slot"][grp[inside], pos[inside]] == live[inside]
    return int((~held).sum())


def test_jax_split_pass_opens_groups_past_its_table() -> None:
    tree = jb.BatchTree(2048, **CFG)
    seen = _fit_recording_groups(tree, _paired_fps(N_DISTINCT))
    # The witness: more live groups than the table holds, and clusters
    # left pointing at cells whose writes were dropped
    assert any(g_num > g_cap for g_num, g_cap in seen), seen
    st = {k: np.asarray(v) for k, v in tree.state._asdict().items()}
    assert _misplaced_clusters(st) > 0
    # What test_pool_telemetry checks still holds
    assert tree.num_clusters == N_DISTINCT and (tree.cluster_sizes() == 2).all()


def test_port_split_pass_stays_in_its_table_at_full_size() -> None:
    fps = _paired_fps(N_DISTINCT)
    tree = tb.BatchTree(2048, device="cpu", **CFG)
    seen = _fit_recording_groups(tree, fps)
    # Live groups never reach the table's guard slot
    assert all(g_num <= g_cap - 1 for g_num, g_cap in seen), seen
    st = state_to_numpy(tree.state)
    assert _misplaced_clusters(st) == 0
    g_num = int(st["g_num"])
    assert st["g_count"][:g_num].sum() == tree.num_clusters
    # Each molecule assigned once; every pair one cluster of two
    assert tree.num_clusters == N_DISTINCT
    mols = tree.cluster_mols()
    assert sorted(i for c in mols for i in c) == list(range(len(fps)))
    np.testing.assert_array_equal(np.bincount(tree.assignments()), tree.cluster_sizes())
    assert (tree.cluster_sizes() == 2).all()
    # Sums equal the members' bits
    bits = np.unpackbits(fps, axis=1).astype(np.int64)
    for ls, members in zip(tree.linear_sums(), mols):
        np.testing.assert_array_equal(ls, bits[members].sum(0))
    # The kill path ran and its leak is counted and bounded
    assert 0 < tree.pool_dead_rows <= int(st["num_ls"])
