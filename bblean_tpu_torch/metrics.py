r"""Clustering quality indices under the Jaccard-Tanimoto metric.

Three indices over a clustering (a list of per-cluster fingerprint arrays):
Calinski-Harabasz via iSIM, Davies-Bouldin over Tanimoto distances, and the
iSIM Dunn variant.  Functionally equivalent to the reference
(``bblean/metrics.py:47-199``) — same formulas, central kinds and edge-case
returns — but vectorized: the per-cluster representatives ("centrals") are
stacked into one packed matrix and every central-vs-central term comes from
a single pairwise similarity matrix instead of nested Python loops.
"""

from __future__ import annotations

import numpy as np
from numpy.typing import NDArray

from bblean_tpu_torch._np_similarity import (
    centroid_from_sum,
    jt_isim_from_sum,
    jt_isim_medoid,
)
from bblean_tpu_torch.fingerprints import pack_fingerprints, unpack_fingerprints
from bblean_tpu_torch.similarity import jt_sim_matrix_packed, jt_sim_packed

__all__ = ["jt_isim_chi", "jt_isim_dunn", "jt_dbi"]

_CentralsArg = "list[NDArray[np.uint8]] | str"


def _packed_view(
    clusters: list[NDArray[np.uint8]], input_is_packed: bool
) -> list[NDArray[np.uint8]]:
    r"""Each cluster's fingerprints as packed uint8 rows."""
    if input_is_packed:
        return clusters
    return [pack_fingerprints(c) for c in clusters]


def _linear_sums(
    clusters: list[NDArray[np.uint8]],
    input_is_packed: bool,
    n_features: int | None,
) -> list[NDArray[np.uint64]]:
    r"""Exact column-wise bit sums, one row per cluster."""
    if input_is_packed:
        clusters = [unpack_fingerprints(c, n_features) for c in clusters]
    return [np.sum(c, axis=0, dtype=np.uint64) for c in clusters]


def _central_matrix(
    clusters: list[NDArray[np.uint8]],
    centrals: _CentralsArg,
    input_is_packed: bool,
    n_features: int | None,
    allowed: tuple[str, ...] = ("centroid", "medoid"),
) -> NDArray[np.uint8]:
    r"""Stack one packed representative per cluster into a (K, F/8) matrix.

    ``centrals`` is either the kind to compute ("centroid" majority vote /
    "medoid" via complementary iSIM) or precomputed per-cluster vectors
    (packed iff ``input_is_packed``).
    """
    if not isinstance(centrals, str):
        rows = centrals if input_is_packed else [
            pack_fingerprints(c) for c in centrals
        ]
        return np.stack(rows)
    if centrals not in allowed:
        if centrals in ("centroid", "medoid"):
            raise NotImplementedError(
                f"Currently only {allowed} centrals are implemented here"
            )
        raise ValueError(f"Unknown arg {centrals} use 'medoid|centroid'")
    if centrals == "medoid":
        rows = [
            jt_isim_medoid(c, input_is_packed, n_features, pack=True)[1]
            for c in clusters
        ]
        return np.stack(rows)
    sums = _linear_sums(clusters, input_is_packed, n_features)
    return np.stack(
        [centroid_from_sum(s, len(c)) for s, c in zip(sums, clusters)]
    )


def _mean_central_distances(
    packed: list[NDArray[np.uint8]], central_mat: NDArray[np.uint8]
) -> NDArray[np.float64]:
    r"""Per-cluster mean Tanimoto distance of the members to their central."""
    return np.array(
        [
            float(np.mean(1.0 - jt_sim_packed(c, central)))
            for c, central in zip(packed, central_mat)
        ]
    )


def jt_isim_chi(
    cluster_fps: list[NDArray[np.uint8]],
    all_fps_central: NDArray[np.uint8] | str = "centroid",
    centrals: _CentralsArg = "centroid",
    input_is_packed: bool = True,
    n_features: int | None = None,
    verbose: bool = False,
) -> float:
    r"""Calinski-Harabasz index via Tanimoto distances (higher is better).

    ``bcss * (N - K) / (wcss * (K - 1))`` where bcss sums the squared
    central-to-global-centroid distances weighted by cluster size and wcss
    the squared member-to-central distances.  Reference formula:
    ``bblean/metrics.py:47-105``.
    """
    sizes = np.array([len(c) for c in cluster_fps])
    n_total = int(sizes.sum())
    k = len(cluster_fps)

    if isinstance(all_fps_central, str):
        if all_fps_central != "centroid":
            # Only the majority-vote global centroid is defined for CHI
            raise NotImplementedError(
                "Currently only ('centroid',) centrals are implemented here"
            )
        total = sum(_linear_sums(cluster_fps, input_is_packed, n_features))
        all_fps_central = centroid_from_sum(total, n_total)

    central_mat = _central_matrix(
        cluster_fps, centrals, input_is_packed, n_features, ("centroid",)
    )
    packed = _packed_view(cluster_fps, input_is_packed)
    if k <= 1:
        return 0

    to_global = 1.0 - jt_sim_packed(central_mat, all_fps_central)
    bcss = float(np.dot(sizes, to_global**2))
    wcss = 0.0
    for c, central in zip(packed, central_mat):
        d = 1.0 - jt_sim_packed(c, central)
        wcss += float(np.dot(d, d))
    return bcss * (n_total - k) / (wcss * (k - 1))


def jt_dbi(
    cluster_fps: list[NDArray[np.uint8]],
    centrals: _CentralsArg = "centroid",
    input_is_packed: bool = True,
    n_features: int | None = None,
    verbose: bool = False,
) -> float:
    r"""Davies-Bouldin index via Tanimoto distances (lower is better).

    Mean-scatter/central-separation ratios, worst pairing per cluster,
    summed and normalized by the total fingerprint count.  Reference
    formula: ``bblean/metrics.py:108-159``.
    """
    central_mat = _central_matrix(
        cluster_fps, centrals, input_is_packed, n_features
    )
    packed = _packed_view(cluster_fps, input_is_packed)
    n_total = sum(len(c) for c in packed)
    if n_total == 0:
        return 0

    scatter = _mean_central_distances(packed, central_mat)
    separation = 1.0 - jt_sim_matrix_packed(central_mat)
    with np.errstate(divide="ignore", invalid="ignore"):
        ratios = (scatter[:, None] + scatter[None, :]) / separation
    np.fill_diagonal(ratios, -np.inf)  # a cluster never pairs with itself
    return float(np.sum(np.max(ratios, axis=1))) / n_total


def jt_isim_dunn(
    cluster_fps: list[NDArray[np.uint8]],
    input_is_packed: bool = True,
    n_features: int | None = None,
    verbose: bool = False,
) -> float:
    r"""Dunn index approximated with iSIM diameters (higher is better).

    Minimum pairwise-union Tanimoto distance over the maximum in-cluster
    iSIM, both computed from exact linear sums.  Reference formula:
    ``bblean/metrics.py:163-199``.
    """
    sums = _linear_sums(cluster_fps, input_is_packed, n_features)
    sizes = [len(c) for c in cluster_fps]
    cohesion = max(
        jt_isim_from_sum(s, n) for s, n in zip(sums, sizes)
    )
    if cohesion == 0:
        return 1
    min_sep = 1.0
    for i in range(len(sums) - 1):
        for j in range(i + 1, len(sums)):
            sep = 1.0 - jt_isim_from_sum(
                sums[i] + sums[j], sizes[i] + sizes[j]
            )
            min_sep = min(min_sep, sep)
    return min_sep / cohesion
