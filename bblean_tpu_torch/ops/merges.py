r"""Batched merge-acceptance predicates on torch tensors.

Port of ``bblean_tpu/ops/merges.py``: evaluate the accept decision for C
candidate merges at once.  Inputs per candidate: the merged linear sum
``new_ls`` / count ``new_n`` and the pre-merge cluster ``old_ls`` /
``old_n`` plus nominee count ``nom_n``.  Returns a bool mask.
"""

from __future__ import annotations

import math

import torch

from bblean_tpu_torch.ops.isim import isim_from_sums, isim_radius_compl_from_sums

__all__ = ["merge_accept_batch", "DEVICE_MERGES"]

_N_MAX = 1000
_DECAY = 1e-3
_OFFSET = math.exp(-_DECAY * _N_MAX)


def _adaptive_tol(tolerance: float | torch.Tensor, old_n: torch.Tensor) -> torch.Tensor:
    tol = tolerance * (torch.exp(-_DECAY * old_n.to(torch.float32)) - _OFFSET)
    return tol.clamp_min(0.0)


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
    if criterion == "never-merge":
        return torch.zeros(new_n.shape, dtype=torch.bool, device=new_n.device)

    if criterion in ("radius", "tolerance-radius"):
        cohesion = isim_radius_compl_from_sums
    else:
        cohesion = isim_from_sums

    new_c = cohesion(new_ls, new_n)
    # new_n >= 2 always holds for merges, so new_c is finite
    screen = new_c >= threshold
    if criterion in ("radius", "diameter"):
        return screen

    old_c = torch.where(
        old_n < 2, 0.0, cohesion(old_ls, old_n.clamp_min(2))
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


DEVICE_MERGES = [
    "radius",
    "diameter",
    "tolerance-diameter",
    "tolerance-radius",
    "tolerance-legacy",
    "never-merge",
]
