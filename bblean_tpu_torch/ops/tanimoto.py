r"""Tanimoto similarity on torch tensors.

Port of ``bblean_tpu/ops/tanimoto.py``.  Two regimes:

1. **Array vs array.**  For binary vectors ``|x & y| = <x, y>``, so the
   (N, C) intersection matrix of N fingerprints against C centroids is one
   matrix product of the unpacked 0/1 planes.  The planes go in as int8 and
   accumulate in int32 (``torch._int_mm``), so the counts are exact at any
   width; the batch engine's routing and row Gram use the same helpers.
2. **Packed array vs one vector.**  AND + popcount over the packed bytes.

Denominator semantics follow the host kernels: union clamped to >= 1.  A
tensor is used on its own device; a numpy array goes to ``device``
(default ``"cuda"``).
"""

from __future__ import annotations

import typing as tp

import torch

from bblean_tpu_torch._device import DeviceLike, as_tensor_on
from bblean_tpu_torch.ops.popcount import popcount_device

__all__ = ["tanimoto_matmul", "intersection_matmul", "tanimoto_packed_arr_vec"]


# -- int8 products -------------------------------------------------------------


def _round_up(x: int, k: int) -> int:
    return -(-x // k) * k


def _pad_int8(a: torch.Tensor, min_rows: int = 1) -> torch.Tensor:
    r"""Zero-pad an (R, K) int8 matrix to rows >= ``min_rows`` and both
    dims multiples of 8 (``torch._int_mm``'s CUDA constraints; a zero row or
    column adds nothing to a product)."""
    r, k = a.shape
    rp = max(_round_up(r, 8), min_rows)
    kp = _round_up(k, 8)
    if (rp, kp) == (r, k):
        return a.contiguous()
    out = torch.zeros((rp, kp), dtype=a.dtype, device=a.device)
    out[:r, :k] = a
    return out


def _int8_gram(a_pad: torch.Tensor, b: torch.Tensor, rows: int) -> torch.Tensor:
    r"""Exact int32 ``a @ b.T`` of 0/1 int8 matrices (``a_pad`` from
    :func:`_pad_int8` with more than 16 rows) -> (rows, len(b))."""
    b_pad = _pad_int8(b)
    return torch._int_mm(a_pad, b_pad.t())[:rows, : b.shape[0]]


# -- similarities ----------------------------------------------------------------


def intersection_matmul(
    queries: tp.Any, centroids: tp.Any, device: DeviceLike | None = None
) -> torch.Tensor:
    r"""(N, F) x (C, F) 0/1 planes -> (N, C) int32 intersection counts."""
    q = as_tensor_on(queries, device).to(torch.int8)
    c = as_tensor_on(centroids, device).to(torch.int8)
    return _int8_gram(_pad_int8(q, 17), c, q.shape[0])


def tanimoto_matmul(
    queries: tp.Any,
    centroids: tp.Any,
    query_pops: torch.Tensor | None = None,
    centroid_pops: torch.Tensor | None = None,
    device: DeviceLike | None = None,
) -> torch.Tensor:
    r"""Full Tanimoto similarity matrix of unpacked 0/1 fps vs centroids.

    ``sim[i, j] = |q_i & c_j| / max(|q_i| + |c_j| - |q_i & c_j|, 1)`` in f32.
    Popcounts may be passed in to amortize across calls.
    """
    queries = as_tensor_on(queries, device)
    centroids = as_tensor_on(centroids, device)
    inter = intersection_matmul(queries, centroids)
    if query_pops is None:
        query_pops = queries.sum(dim=-1, dtype=torch.int32)
    if centroid_pops is None:
        centroid_pops = centroids.sum(dim=-1, dtype=torch.int32)
    union = query_pops[:, None] + centroid_pops[None, :] - inter
    return inter.to(torch.float32) / union.clamp_min(1).to(torch.float32)


def tanimoto_packed_arr_vec(
    x: tp.Any, y: tp.Any, device: DeviceLike | None = None
) -> torch.Tensor:
    r"""Tanimoto of packed (N, B) rows vs one packed (B,) vector."""
    x = as_tensor_on(x, device)
    y = as_tensor_on(y, device)
    inter = popcount_device(x & y[None, :])
    union = popcount_device(x) + popcount_device(y) - inter
    return inter.to(torch.float32) / union.clamp_min(1).to(torch.float32)
