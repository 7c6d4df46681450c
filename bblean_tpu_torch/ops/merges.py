r"""Batched merge-acceptance predicates on torch tensors.

Port of ``bblean_tpu/ops/merges.py``: evaluate the accept decision for C
candidate merges at once.  Inputs per candidate: the merged linear sum
``new_ls`` / count ``new_n`` and the pre-merge cluster ``old_ls`` /
``old_n`` plus nominee count ``nom_n``.  Returns a bool mask.

:func:`merge_accept_batch` is :func:`merge_moments` (the exact int64
moments of the (C, F) sums that the criterion reads) followed by
:func:`merge_accept_from_moments` (the O(C) tail).  The insert round's
prefix commits compute the same moments in one kernel
(``ops/prefix_commit.py``) and share the tail.
"""

from __future__ import annotations

import math

import torch

from bblean_tpu_torch.ops.isim import (
    isim_from_moments,
    isim_radius_compl_from_moments,
    radius_moments,
    sum_moments,
)

__all__ = [
    "merge_accept_batch",
    "merge_accept_from_moments",
    "merge_moments",
    "moment_count",
    "DEVICE_MERGES",
]

_N_MAX = 1000
_DECAY = 1e-3
_OFFSET = math.exp(-_DECAY * _N_MAX)


def _adaptive_tol(tolerance: float | torch.Tensor, old_n: torch.Tensor) -> torch.Tensor:
    tol = tolerance * (torch.exp(-_DECAY * old_n.to(torch.float32)) - _OFFSET)
    return tol.clamp_min(0.0)


def _radius(criterion: str) -> bool:
    return criterion in ("radius", "tolerance-radius")


def _reads_old(criterion: str) -> bool:
    return criterion.startswith("tolerance-")


def moment_count(criterion: str) -> int:
    r"""Rows of :func:`merge_moments`' result for ``criterion``: (K, Ksq)
    of the merged sums, with (K1, Ksq1) of the sums plus their centroid
    for the radius criteria, and the same again of the pre-merge sums for
    the tolerance criteria; none for never-merge."""
    if criterion == "never-merge":
        return 0
    if criterion not in DEVICE_MERGES:
        raise ValueError(f"Unknown merge criterion {criterion}")
    return (4 if _radius(criterion) else 2) * (2 if _reads_old(criterion) else 1)


def merge_moments(
    criterion: str,
    new_ls: torch.Tensor,
    new_n: torch.Tensor,
    old_ls: torch.Tensor,
    old_n: torch.Tensor,
) -> torch.Tensor:
    r"""(:func:`moment_count`, C) int64: the moments of the merged sums
    ``new_ls`` (the radius criteria's centroid at ``new_n``) and, for the
    tolerance criteria, of the pre-merge sums ``old_ls`` (centroid at
    ``old_n.clamp_min(2)``)."""
    c = new_n.shape[0]
    if moment_count(criterion) == 0:
        return torch.zeros((0, c), dtype=torch.int64, device=new_n.device)
    if _radius(criterion):
        out = [*radius_moments(new_ls, new_n)]
        if _reads_old(criterion):
            out += radius_moments(old_ls, old_n.clamp_min(2))
    else:
        out = [*sum_moments(new_ls)]
        if _reads_old(criterion):
            out += sum_moments(old_ls)
    return torch.stack(out)


def merge_accept_from_moments(
    criterion: str,
    threshold: float | torch.Tensor,
    moments: torch.Tensor,
    new_n: torch.Tensor,
    old_n: torch.Tensor,
    nom_n: torch.Tensor,
    tolerance: float | torch.Tensor = 0.05,
) -> torch.Tensor:
    r"""Batched merge-accept mask from :func:`merge_moments`' result."""
    if criterion == "never-merge":
        return torch.zeros(new_n.shape, dtype=torch.bool, device=new_n.device)

    if _radius(criterion):
        cohesion, width = isim_radius_compl_from_moments, 4
    else:
        cohesion, width = isim_from_moments, 2

    new_c = cohesion(*moments[:width], new_n)
    # new_n >= 2 always holds for merges, so new_c is finite
    screen = new_c >= threshold
    if criterion in ("radius", "diameter"):
        return screen

    old_c = torch.where(
        old_n < 2, 0.0, cohesion(*moments[width:2 * width], old_n.clamp_min(2))
    )
    if criterion in ("tolerance-diameter", "tolerance-radius"):
        tol = _adaptive_tol(tolerance, old_n)
        keep = (old_n == 1) | (new_c >= old_c - tol)
        return screen & keep
    if criterion == "tolerance-legacy":
        trivial = (old_n == 1) | (nom_n != 1)
        nf = new_n.to(torch.float32)
        of = old_n.to(torch.float32)
        growth = (new_c * nf - old_c * (of - 1)) * 0.5 >= old_c - tolerance
        return screen & (trivial | growth)
    raise ValueError(f"Unknown merge criterion {criterion}")


def merge_accept_batch(
    criterion: str,
    threshold: float | torch.Tensor,
    new_ls: torch.Tensor,
    new_n: torch.Tensor,
    old_ls: torch.Tensor,
    old_n: torch.Tensor,
    nom_n: torch.Tensor,
    tolerance: float | torch.Tensor = 0.05,
) -> torch.Tensor:
    r"""Batched merge-accept mask for one of the six builtin criteria."""
    return merge_accept_from_moments(
        criterion, threshold, merge_moments(criterion, new_ls, new_n, old_ls, old_n),
        new_n, old_n, nom_n, tolerance=tolerance,
    )


DEVICE_MERGES = [
    "radius",
    "diameter",
    "tolerance-diameter",
    "tolerance-radius",
    "tolerance-legacy",
    "never-merge",
]
