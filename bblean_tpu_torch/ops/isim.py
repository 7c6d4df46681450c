r"""Batched iSIM and radius cohesion on torch tensors.

Port of ``bblean_tpu/ops/isim.py``.  One change of method in
:func:`isim_from_sums`: the JAX version sums ``K`` and ``Ksq`` in f32 and
evaluates ``a / (a + n*K - Ksq)`` in f32, which is exact only while every
intermediate stays below 2^24 (``Ksq`` of a 2048-bit cluster passes that at
about 90 members); past that its result depends on the backend's reduction
order and on whether the compiler fuses a multiply-add.  Here ``K``,
``Ksq``, ``a`` and the denominator are EXACT int64 values, and the quotient
is taken in float64 and rounded once to f32.  Float64 has more than
2 * 24 + 2 bits of significand, so that double rounding gives the correctly
rounded f32 iSIM: the CPU and CUDA runs agree bit for bit, and they agree
with JAX wherever JAX's f32 steps are exact (its one rounding is then the
same quotient's).

Each cohesion is split into its moments (exact int64 sums over the
columns: :func:`sum_moments`, :func:`radius_moments`) and a tail that turns
moments into the f32 value (:func:`isim_from_moments`,
:func:`isim_radius_compl_from_moments`), so that a kernel that computes the
moments without the (C, F) sums in memory (``ops/prefix_commit.py``) feeds
the very same tail.
"""

from __future__ import annotations

import torch

__all__ = [
    "isim_from_sums",
    "isim_from_moments",
    "isim_radius_compl_from_sums",
    "isim_radius_compl_from_moments",
    "majority_centroid_from_sums",
    "radius_moments",
    "sum_moments",
]


def sum_moments(ls: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    r"""``(K, Ksq)``: the int64 sums of ``ls`` and of its squares over the
    last axis (exact; wrapping modulo 2^64 as int64 arithmetic does)."""
    ls64 = ls.to(torch.int64)
    return ls64.sum(dim=-1), (ls64 * ls64).sum(dim=-1)


def isim_from_moments(k: torch.Tensor, ksq: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    r"""Batched iSIM from the moments of :func:`sum_moments` and (C,)
    counts -> (C,) f32: all-zero sums give 1.0; ``n < 2`` gives NaN."""
    a = (ksq - k) // 2  # sum of ls * (ls - 1) / 2: an integer
    denom = a + n.to(torch.int64) * k - ksq
    isim = (a.to(torch.float64) / denom.to(torch.float64)).to(torch.float32)
    isim = torch.where(k == 0, 1.0, isim)
    return torch.where(n < 2, torch.nan, isim)


def isim_from_sums(ls: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    r"""Batched iSIM: ``ls`` (C, F) linear sums, ``n`` (C,) counts -> (C,) f32.

    All-zero sums give 1.0; ``n < 2`` gives NaN (host semantics).
    """
    return isim_from_moments(*sum_moments(ls), n)


def majority_centroid_from_sums(ls: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    r"""Batched majority-vote centroid: (C, F) sums, (C,) counts -> (C, F) u8.

    For ``n <= 1`` the centroid is the (0/1) linear sum itself.
    """
    half = n.to(torch.float32)[:, None] * 0.5
    vote = (ls.to(torch.float32) >= half).to(torch.uint8)
    single = ls.clamp(0, 1).to(torch.uint8)
    return torch.where(n[:, None] <= 1, single, vote)


def radius_moments(ls: torch.Tensor, n: torch.Tensor) -> tuple[torch.Tensor, ...]:
    r"""``(K, Ksq, K1, Ksq1)``: :func:`sum_moments` of ``ls`` and of ``ls``
    plus its majority-vote centroid at counts ``n``."""
    cent = majority_centroid_from_sums(ls, n)
    return (*sum_moments(ls), *sum_moments(ls + cent.to(ls.dtype)))


def isim_radius_compl_from_moments(
    k: torch.Tensor, ksq: torch.Tensor, k1: torch.Tensor, ksq1: torch.Tensor,
    n: torch.Tensor,
) -> torch.Tensor:
    r"""Batched complement-of-radius cohesion from the moments of
    :func:`radius_moments` and (C,) counts."""
    nf = n.to(torch.float32)
    isim_n = isim_from_moments(k, ksq, n)
    # n == 1 has undefined isim; the (n - 1) weight zeroes it out, so
    # substitute a finite value to avoid NaN propagation
    isim_n = torch.where(n < 2, 0.0, isim_n)
    isim_n1 = isim_from_moments(k1, ksq1, n + 1)
    return (isim_n1 * (nf + 1) - isim_n * (nf - 1)) * 0.5


def isim_radius_compl_from_sums(ls: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    r"""Batched complement-of-radius cohesion from linear sums and counts."""
    return isim_radius_compl_from_moments(*radius_moments(ls, n), n)
