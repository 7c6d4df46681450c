r"""Plain reference check of one library's clustering.

Takes the library (packed rows, as the benchmark made it) and what the
program returns for it: the cluster of every row (``assignments()``), the
count of every cluster (``cluster_sizes()``) and the cluster tables the
program keeps (``BatchTree.state``: each cluster's count ``n``, its
linear-sum pool row ``ls_ref`` into ``ls``, its tile cell ``(group, pos)``
holding its packed majority-vote centroid ``t_pk`` and the cell's owner
``t_slot``).  From the library and the assignments alone it works out each
cluster's members, linear sums, majority vote and iSIM again, in plain
PyTorch on the device, in blocks of clusters, and counts what disagrees:

- ``rows_not_once``: rows with no cluster or a cluster out of range, and
  cluster ids past the library;
- ``count_mismatch``: clusters whose count is not their members' number,
  or is 0;
- ``sum_mismatch``: multi-member clusters whose pool row is not the sum
  of their members' bits (a multi-member cluster without a pool row
  counts), and pooled singletons whose row is not their bits;
- ``centroid_mismatch``: clusters whose tile cell is not the majority vote
  of the members' sums (a singleton's: its bits) or is not theirs;
- ``criterion_gap``: the widest gap by which a multi-member cluster's iSIM,
  exact in float64, lies below the threshold (the diameter criterion: every
  merge keeps the merged cluster's iSIM at or above it); -1 without
  multi-member clusters;
- ``merge_share_gap``: how far the share of rows that joined a cluster
  rather than starting one, ``(rows - clusters) / rows``, lies from the
  share the configuration states for its library, as a fraction of that
  share.  The numbers above hold whatever the fit decided (a fit that
  merges nothing passes them); this one reads the decisions of the route,
  the tile search, the merge tests and the election: a fit that misses
  merges, or makes more, moves it.

Imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.library import pack_bits, unpack_bits

__all__ = ["NAMES", "check_clustering"]

NAMES = (
    "rows_not_once", "count_mismatch", "sum_mismatch", "centroid_mismatch", "criterion_gap",
    "merge_share_gap",
)


def _isim(ls: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    r"""iSIM (average pairwise Tanimoto) of (C, F) sums at (C,) counts >= 2,
    from exact int64 moments, the quotient in float64; all-zero sums 1."""
    ls = ls.to(torch.int64)
    k = ls.sum(-1)
    ksq = (ls * ls).sum(-1)
    a = (ksq - k) // 2
    denom = a + n.to(torch.int64) * k - ksq
    isim = a.to(torch.float64) / denom.clamp_min(1).to(torch.float64)
    return torch.where(k == 0, torch.ones_like(isim), isim)


def check_clustering(
    library: torch.Tensor,
    assignments: np.ndarray,
    sizes: np.ndarray,
    tables: dict[str, torch.Tensor],
    threshold: float,
    criterion: str,
    merge_share: float,
    *,
    block: int = 1 << 15,
) -> dict[str, float]:
    r"""The numbers of the module docstring for one clustering.

    ``library`` is (N, F8) uint8 on the device the check runs on;
    ``tables`` maps ``n``, ``ls_ref``, ``ls``, ``group``, ``pos``, ``t_pk``
    and ``t_slot`` to the program's tensors (moved to that device here);
    ``merge_share`` is the configuration's share of rows merged.
    """
    if criterion != "diameter":
        raise ValueError(f"the reference checks the diameter criterion, not {criterion!r}")
    dev = library.device
    n_rows, f8 = library.shape
    n_clusters = len(sizes)
    tab = {k: v.to(dev) for k, v in tables.items()}

    # Every row in one cluster: ids past the library and rows without a
    # cluster both count
    asg = np.full(n_rows, -1, np.int64)
    asg[: min(n_rows, len(assignments))] = assignments[:n_rows]
    bad = (asg < 0) | (asg >= n_clusters)
    rows_not_once = int(bad.sum()) + max(0, len(assignments) - n_rows)
    members = np.bincount(asg[~bad], minlength=n_clusters)
    count_mismatch = int(((members != sizes) | (sizes < 1)).sum())

    asg_d = torch.from_numpy(np.where(bad, n_clusters, asg)).to(dev)
    order = torch.argsort(asg_d, stable=True)
    starts = np.concatenate([[0], np.cumsum(members)])
    sum_mismatch = centroid_mismatch = 0
    worst = -1.0
    for c0 in range(0, n_clusters, block):
        c1 = min(c0 + block, n_clusters)
        rows = order[int(starts[c0]) : int(starts[c1])]
        local = asg_d[rows] - c0
        ref_ls = torch.zeros((c1 - c0, 8 * f8), dtype=torch.int32, device=dev)
        ref_ls.index_add_(0, local, unpack_bits(library[rows]).to(torch.int32))
        ref_n = torch.from_numpy(members[c0:c1]).to(dev)

        # Sums: a pool row where the program keeps one; a multi-member
        # cluster must keep one
        ref = tab["ls_ref"][c0:c1].long()
        pooled = ref >= 0
        in_pool = ref < tab["ls"].shape[0]
        pool_rows = tab["ls"][ref.clamp(0, tab["ls"].shape[0] - 1)]
        wrong_sum = pooled & (~in_pool | (pool_rows != ref_ls).any(-1))
        sum_mismatch += int((wrong_sum | (~pooled & (ref_n >= 2))).sum())

        # Centroids: the cluster's tile cell, and the cell's owner
        vote = torch.where(
            (ref_n >= 2)[:, None], 2 * ref_ls >= ref_n[:, None], ref_ls.clamp(0, 1) > 0
        ).to(torch.uint8)
        grp, pos = tab["group"][c0:c1].long(), tab["pos"][c0:c1].long()
        n_groups, tile = tab["t_slot"].shape
        in_tile = (grp >= 0) & (grp < n_groups) & (pos >= 0) & (pos < tile)
        grp, pos = grp.clamp(0, n_groups - 1), pos.clamp(0, tile - 1)
        cells = tab["t_pk"][grp, pos]
        owner = tab["t_slot"][grp, pos].long()
        slots = torch.arange(c0, c1, device=dev)
        wrong_cell = ~in_tile | (cells != pack_bits(vote)).any(-1) | (owner != slots)
        centroid_mismatch += int(wrong_cell.sum())

        multi = ref_n >= 2
        if bool(multi.any()):
            gap = threshold - _isim(ref_ls[multi], ref_n[multi])
            worst = max(worst, float(gap.max()))
    return {
        "rows_not_once": rows_not_once,
        "count_mismatch": count_mismatch,
        "sum_mismatch": sum_mismatch,
        "centroid_mismatch": centroid_mismatch,
        "criterion_gap": worst,
        "merge_share_gap": abs((n_rows - n_clusters) / n_rows - merge_share) / merge_share,
    }
