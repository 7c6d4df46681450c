r"""Host (NumPy) reference kernels for Tanimoto / iSIM similarity.

These are the bit-exact semantic anchors of the framework: every accelerated
backend (the native C++ host engine and the PyTorch / CUDA device ops in
``bblean_tpu_torch.ops``) is validated against them.  Numeric contracts they encode
(matching reference ``bblean/_py_similarity.py``):

- Pairwise Tanimoto is ``|x & y| / max(|x| + |y| - |x & y|, 1)`` in float64;
  the denominator clamp makes the similarity of two all-zero fps 1.0
  (reference ``_py_similarity.py:196-214``).
- ``jt_isim_from_sum`` returns 1.0 when the linear sum is all zeros, NaN (with
  a RuntimeWarning) for fewer than 2 objects, and otherwise
  ``a / (a + n*K - Ksq)`` with ``a = (Ksq - K) / 2`` computed in float64 from
  exact uint64 integer sums (``_py_similarity.py:236-278``).
- The majority-vote centroid is ``ls >= n * 0.5`` for ``n > 1`` and the sample
  itself for ``n <= 1`` (``_py_similarity.py:12-42``).
- ``jt_most_dissimilar_packed`` is the O(N) centroid -> fp1 -> fp2 heuristic
  with first-occurrence argmin ties (``_py_similarity.py:138-178``).
"""

from __future__ import annotations

import warnings

import numpy as np
from numpy.typing import NDArray

from bblean_tpu_torch.fingerprints import pack_fingerprints, unpack_fingerprints
from bblean_tpu_torch.utils import min_safe_uint

__all__ = [
    "centroid_from_sum",
    "centroid",
    "jt_compl_isim",
    "jt_isim_medoid",
    "jt_isim_from_sum",
    "jt_isim_packed",
    "jt_isim_unpacked",
    "jt_most_dissimilar_packed",
]


def popcount(a: NDArray[np.uint8]) -> NDArray[np.uint32]:
    r"""Per-row popcount of a packed uint8 array (sums over the last axis)."""
    b: NDArray[np.integer]
    try:
        # uint64 reinterpret is slightly faster when the byte count allows it
        b = a.view(np.uint64)
    except ValueError:
        b = a
    return np.bitwise_count(b).sum(axis=-1, dtype=np.uint32)


# Kept under the reference-internal name so dual-backend tests read naturally
_popcount = popcount


def centroid_from_sum(
    linear_sum: NDArray[np.integer], n_samples: int, *, pack: bool = True
) -> NDArray[np.uint8]:
    r"""Majority-vote centroid from a column-wise linear sum of fingerprints."""
    if n_samples <= 1:
        cent = linear_sum.astype(np.uint8, copy=False)
    else:
        # numpy guarantees bools are exactly 0x00/0x01 under a uint8 view
        cent = (linear_sum >= n_samples * 0.5).view(np.uint8)
    if pack:
        return np.packbits(cent, axis=-1)
    return cent


def centroid(
    fps: NDArray[np.uint8],
    input_is_packed: bool = True,
    n_features: int | None = None,
    *,
    pack: bool = True,
) -> NDArray[np.uint8]:
    r"""Majority-vote centroid of a set of fingerprints."""
    if input_is_packed:
        fps = unpack_fingerprints(fps, n_features)
    return centroid_from_sum(
        np.sum(fps, axis=0, dtype=np.uint64), len(fps), pack=pack
    )


def jt_isim_from_sum(linear_sum: NDArray[np.integer], n_objects: int) -> float:
    r"""iSIM Jaccard-Tanimoto from a linear sum and an object count.

    O(N) estimator of the average pairwise Tanimoto similarity of a set
    (equivalently, 1 minus the Tanimoto diameter).
    """
    if n_objects < 2:
        warnings.warn(
            f"Invalid n_objects = {n_objects} in isim. Expected n_objects >= 2",
            RuntimeWarning,
            stacklevel=2,
        )
        return np.nan
    x = linear_sum.astype(np.uint64, copy=False)
    sum_k = np.sum(x)
    if sum_k == 0:
        # All-zero fingerprints are identical, hence perfectly similar
        return 1
    sum_ksq = np.dot(x, x)  # dot conserves the uint64 dtype (exact)
    a = (sum_ksq - sum_k) / 2  # float64 from here on
    return a / (a + n_objects * sum_k - sum_ksq)


def jt_isim_unpacked(arr: NDArray[np.integer]) -> float:
    r"""iSIM of a set of unpacked fingerprints."""
    return jt_isim_from_sum(np.sum(arr, axis=0, dtype=np.uint64), len(arr))


def jt_isim_packed(fps: NDArray[np.integer], n_features: int | None = None) -> float:
    r"""iSIM of a set of packed fingerprints."""
    return jt_isim_from_sum(
        np.sum(unpack_fingerprints(fps, n_features), axis=0, dtype=np.uint64),
        len(fps),
    )


def _jt_sim_packed_precalc_cardinalities(
    x: NDArray[np.uint8],
    y: NDArray[np.uint8],
    cardinalities: NDArray[np.integer],
) -> NDArray[np.float64]:
    r"""Tanimoto of each packed row of ``x`` vs packed vector ``y``.

    ``cardinalities`` must equal ``popcount(x)``.  The union in the denominator
    is clamped to >= 1, so a pair of all-zero fps scores 1.0 rather than NaN.
    """
    intersection = popcount(np.bitwise_and(x, y))
    return intersection / np.maximum(cardinalities + popcount(y) - intersection, 1)


def _jt_sim_arr_vec_packed(
    x: NDArray[np.uint8], y: NDArray[np.uint8]
) -> NDArray[np.float64]:
    r"""Tanimoto of a packed (N, B) array against one packed (B,) vector."""
    if x.ndim != 2 or y.ndim != 1:
        raise ValueError("Expected a 2D array and a 1D vector as inputs")
    return _jt_sim_packed_precalc_cardinalities(x, y, popcount(x))


def jt_most_dissimilar_packed(
    Y: NDArray[np.uint8], n_features: int | None = None
) -> tuple[np.integer, np.integer, NDArray[np.float64], NDArray[np.float64]]:
    r"""O(N) heuristic for the most Tanimoto-dissimilar pair in a packed array.

    Picks fp1 as the row least similar to the majority-vote centroid, then fp2
    as the row least similar to fp1.  Returns ``(fp1, fp2, sims_to_fp1,
    sims_to_fp2)``.  Robust seed selection for node splits.
    """
    n_samples = len(Y)
    unpacked = unpack_fingerprints(Y, n_features)
    linear_sum = np.sum(unpacked, axis=0, dtype=min_safe_uint(n_samples))
    packed_centroid = centroid_from_sum(linear_sum, n_samples, pack=True)

    cards = popcount(Y)
    sims_cent = _jt_sim_packed_precalc_cardinalities(Y, packed_centroid, cards)
    fp_1 = np.argmin(sims_cent)
    sims_fp_1 = _jt_sim_packed_precalc_cardinalities(Y, Y[fp_1], cards)
    fp_2 = np.argmin(sims_fp_1)
    sims_fp_2 = _jt_sim_packed_precalc_cardinalities(Y, Y[fp_2], cards)
    return fp_1, fp_2, sims_fp_1, sims_fp_2


def jt_compl_isim(
    fps: NDArray[np.uint8], input_is_packed: bool = True, n_features: int | None = None
) -> NDArray[np.float64]:
    r"""Complementary iSIM of every fingerprint (iSIM of the set minus it)."""
    if input_is_packed:
        fps = unpack_fingerprints(fps, n_features)
    n_rest = len(fps) - 1
    if n_rest < 2:
        warnings.warn(
            "Invalid fps. len(fps) must be >= 3", RuntimeWarning, stacklevel=2
        )
        return np.full(len(fps), fill_value=np.nan, dtype=np.float64)
    linear_sum = np.sum(fps, axis=0)
    return np.array(
        [jt_isim_from_sum(linear_sum - fp, n_rest) for fp in fps], dtype=np.float64
    )


def jt_isim_medoid(
    fps: NDArray[np.uint8],
    input_is_packed: bool = True,
    n_features: int | None = None,
    pack: bool = True,
) -> tuple[int, NDArray[np.uint8]]:
    r"""Tanimoto medoid of a set via complementary iSIM.

    Returns ``(index, medoid_fp)``.  For fewer than 3 fps the medoid is
    undefined and the first fingerprint is returned.
    """
    if not fps.size:
        raise ValueError("Size of fingerprints set must be > 0")
    if input_is_packed:
        fps = unpack_fingerprints(fps, n_features)
    if len(fps) < 3:
        idx = 0
    else:
        idx = int(np.argmin(jt_compl_isim(fps, input_is_packed=False)))
    medoid = fps[idx]
    if pack:
        return idx, pack_fingerprints(medoid)
    return idx, medoid
