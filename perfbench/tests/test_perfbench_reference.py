r"""The plain reference (``perfbench/reference.py``) against real fits of the
port on the CPU, sound and corrupted."""

from __future__ import annotations

import numpy as np
import pytest

from perfbench.library import make_library
from perfbench.reference import NAMES, check_clustering

N, BATCH = 4096, 256
TABLES = ("n", "ls_ref", "ls", "group", "pos", "t_pk", "t_slot")


@pytest.fixture(scope="module")
def fitted():
    from bblean_tpu_torch import BatchTree

    lib = make_library(
        N, 2048, 2**31 + 9, popcount_loc=750, popcount_scale=400, popcount_min=1,
        popcount_max=2047, chunk_rows=2048, device="cpu",
    )
    tree = BatchTree(2048, threshold=0.3, batch_size=BATCH, initial_capacity=N + BATCH + 1, device="cpu")
    tree.fit_packed(lib.numpy(), range(N))
    return lib, tree


def _inputs(fitted):
    lib, tree = fitted
    tables = {k: getattr(tree.state, k).clone() for k in TABLES}
    return lib, tree.assignments().copy(), tree.cluster_sizes().copy(), tables


def _check(lib, asg, sizes, tables, threshold=0.3, merge_share=None):
    if merge_share is None:  # the fit's own share
        merge_share = (N - len(sizes)) / N
    return check_clustering(lib, asg, sizes, tables, threshold, "diameter", merge_share, block=700)


def test_accepts_the_ports_fit(fitted):
    got = _check(*_inputs(fitted))
    assert set(got) == set(NAMES)
    assert got["rows_not_once"] == got["count_mismatch"] == 0
    assert got["sum_mismatch"] == got["centroid_mismatch"] == 0
    assert got["criterion_gap"] <= 0 and got["merge_share_gap"] == 0


def test_refuses_a_row_moved_to_another_cluster(fitted):
    lib, asg, sizes, tables = _inputs(fitted)
    asg[0] = (asg[0] + 1) % len(sizes)
    got = _check(lib, asg, sizes, tables)
    assert got["count_mismatch"] == 2 and got["sum_mismatch"] + got["centroid_mismatch"] > 0


def test_refuses_a_changed_sum(fitted):
    lib, asg, sizes, tables = _inputs(fitted)
    multi = int(np.flatnonzero(sizes >= 2)[0])
    tables["ls"][int(tables["ls_ref"][multi]), 5] += 1
    assert _check(lib, asg, sizes, tables)["sum_mismatch"] == 1


def test_refuses_a_changed_centroid(fitted):
    lib, asg, sizes, tables = _inputs(fitted)
    g, p = int(tables["group"][3]), int(tables["pos"][3])
    tables["t_pk"][g, p, 0] ^= 1
    assert _check(lib, asg, sizes, tables)["centroid_mismatch"] == 1


def test_refuses_rows_left_out_and_a_count_changed(fitted):
    lib, asg, sizes, tables = _inputs(fitted)
    got = _check(lib, asg[: N // 2], sizes, tables)
    assert got["rows_not_once"] == N - N // 2
    sizes[1] += 1
    assert _check(lib, asg, sizes, tables)["count_mismatch"] == 1


def test_criterion_gap_reads_a_loose_cluster(fitted):
    lib, asg, sizes, tables = _inputs(fitted)
    # At a threshold above every cluster's iSIM the widest gap is positive
    assert _check(lib, asg, sizes, tables, threshold=0.99)["criterion_gap"] > 0.5



def test_merge_share_gap_reads_the_share_of_rows_merged(fitted):
    lib, asg, sizes, tables = _inputs(fitted)
    share = (N - len(sizes)) / N
    # A fit that merged 10% fewer rows than the configuration states
    got = _check(lib, asg, sizes, tables, merge_share=share / 0.9)["merge_share_gap"]
    assert abs(got - 0.1) < 1e-12
    assert abs(_check(lib, asg, sizes, tables, merge_share=share / 1.1)["merge_share_gap"] - 0.1) < 1e-12
