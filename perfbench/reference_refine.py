r"""Plain reference check of one refined clustering.

A refine (``bb run --refine-num K``: ``BatchTree.refine_inplace``) takes a
fitted library, explodes its ``K`` largest clusters into single rows, puts
every other cluster back whole as a CF buffer (its count and linear sums,
one row), and fits the exploded rows again.  This judges the result from
the library, the clustering before the refine (the cluster of every row)
and what the program returns after it:

- everything :func:`perfbench.reference.check_clustering` reads, under the
  diameter criterion at the refine's threshold: the refine's
  tolerance-diameter test accepts a merge only where the diameter test
  accepts it (``bblean_tpu_torch/ops/merges.py``), so every refined
  multi-member cluster still has iSIM >= t.  Its ``merge_share_gap`` reads
  the refined share of rows merged against the refined share the traffic
  mix states for the library;
- ``survivor_split``: clusters of the fit before the refine whose rows now
  lie in more than one refined cluster, that cannot have been exploded.
  A buffer enters whole and a cluster only ever grows, so no survivor
  splits; only the ``K`` largest may.  Every split cluster smaller than
  the ``K``-th largest size counts, and of those at that size or larger
  every one beyond ``K``.  An exploded cluster that forms again reads as
  unsplit, so nothing tells which ``K`` were exploded, and ties at the
  ``K``-th size need not be told apart.

Imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench import reference

__all__ = ["NAMES", "TABLES", "check_refine", "survivor_split"]

NAMES = (*reference.NAMES, "survivor_split")
# The tables of BatchTree.state that the reference judges
TABLES = ("n", "ls_ref", "ls", "group", "pos", "t_pk", "t_slot")


def _padded(assignments: np.ndarray, n_rows: int) -> np.ndarray:
    out = np.full(n_rows, -1, np.int64)
    out[: min(n_rows, len(assignments))] = assignments[:n_rows]
    return out


def survivor_split(before: np.ndarray, after: np.ndarray, n_largest: int) -> int:
    r"""The ``survivor_split`` of the module docstring; ``before`` and
    ``after`` give each row's cluster (rows without one, < 0, are left
    out: ``rows_not_once`` counts them)."""
    n_rows = max(len(before), len(after))
    before, after = _padded(before, n_rows), _padded(after, n_rows)
    ok = (before >= 0) & (after >= 0)
    if not ok.any():
        return 0
    sizes = np.bincount(before[ok])
    width = int(after[ok].max()) + 1
    pairs = np.unique(before[ok] * width + after[ok])
    parts = np.bincount(pairs // width, minlength=len(sizes))
    split = parts > 1
    kth = np.sort(sizes)[::-1][n_largest - 1] if 0 < n_largest <= len(sizes) else 0
    big = split & (sizes >= kth) if n_largest > 0 else np.zeros_like(split)
    return int((split & ~big).sum()) + max(0, int(big.sum()) - n_largest)


def check_refine(
    library: torch.Tensor,
    before: np.ndarray,
    after: np.ndarray,
    sizes: np.ndarray,
    tables: dict[str, torch.Tensor],
    threshold: float,
    merge_share: float,
    n_largest: int,
) -> dict[str, float]:
    r"""The numbers of :data:`NAMES` for one refined clustering.

    ``library`` is (N, F8) uint8 on the device the check runs on;
    ``before`` is the cluster of every row before the refine, ``after``
    and ``sizes`` the program's ``assignments()`` and ``cluster_sizes()``
    after it, ``tables`` its :data:`TABLES`; ``merge_share`` is the refined
    share of rows merged that the traffic mix states.
    """
    out = reference.check_clustering(
        library, after, sizes, tables, threshold, "diameter", merge_share,
    )
    out["survivor_split"] = survivor_split(before, after, n_largest)
    return out
