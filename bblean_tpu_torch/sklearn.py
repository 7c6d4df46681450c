r"""scikit-learn estimator adapters for BitBirch.

Drop-in replacements for ``sklearn.cluster.Birch`` honoring the estimator
contract (fit / partial_fit / fit_predict / predict / transform / get_params
/ set_params / set_output / feature names out), with Jaccard distances
against the fitted subcluster centroids. Behavior parity with the reference
adapter (``bblean/sklearn.py:51-203``); the packed/unpacked pair is realized
here via a single class-level input-format default rather than per-method
overrides.
"""

from __future__ import annotations

import typing as tp

import numpy as np
from numpy.typing import NDArray

from sklearn.base import (
    BaseEstimator,
    ClassNamePrefixFeaturesOutMixin,
    ClusterMixin,
    TransformerMixin,
    _fit_context,
)
from sklearn.metrics import pairwise_distances, pairwise_distances_argmin
from sklearn.utils.validation import check_is_fitted, validate_data

from bblean_tpu_torch._merges import MergeAcceptFunction
from bblean_tpu_torch.fingerprints import unpack_fingerprints
from bblean_tpu_torch.tree import BitBirch as _CoreTree

__all__ = ["BitBirch", "UnpackedBitBirch"]


class BitBirch(
    ClassNamePrefixFeaturesOutMixin,
    ClusterMixin,
    TransformerMixin,
    BaseEstimator,
    _CoreTree,
):
    r"""sklearn-contract BitBIRCH estimator.

    Inputs are *packed* fingerprints unless ``input_is_packed`` says
    otherwise per call; ``UnpackedBitBirch`` flips the default.
    """

    # Resolves `input_is_packed=None` in every method; the unpacked
    # subclass only overrides this attribute.
    _packed_by_default: tp.ClassVar[bool] = True

    _parameter_constraints: dict[str, list[tp.Any]] = {}

    def __init__(
        self,
        *,
        threshold: float = 0.65,
        branching_factor: int = 50,
        merge_criterion: str | MergeAcceptFunction | None = None,
        tolerance: float | None = None,
        compute_labels: bool = True,
    ):
        _CoreTree.__init__(
            self,
            threshold=threshold,
            branching_factor=branching_factor,
            merge_criterion=merge_criterion,
            tolerance=tolerance,
        )
        self.compute_labels = compute_labels

    # -- fitting --

    def _resolve_packed(self, input_is_packed: bool | None) -> bool:
        if input_is_packed is None:
            return self._packed_by_default
        return input_is_packed

    def _post_fit(self) -> None:
        r"""Populate the sklearn-side fitted attributes from the tree."""
        engine = self._require_engine()
        rows = [
            unpack_fingerprints(engine.sub_packed_centroid(s), engine.n_features)
            for s in engine.leaf_sub_ids(sort=True)
        ]
        self.subcluster_centers_ = np.stack(rows)
        self.subcluster_labels_ = np.arange(1, len(rows) + 1)
        self._n_features_out = len(rows)
        if self.compute_labels:
            self.labels_ = self.get_assignments()

    @_fit_context(prefer_skip_nested_validation=True)
    def fit(  # type: ignore[override]
        self,
        X,
        y=None,
        input_is_packed: bool | None = None,
        n_features: int | None = None,
    ) -> "BitBirch":
        _CoreTree.fit(
            self,
            X,
            input_is_packed=self._resolve_packed(input_is_packed),
            n_features=n_features,
        )
        self._post_fit()
        return self

    @_fit_context(prefer_skip_nested_validation=True)
    def partial_fit(  # type: ignore[override]
        self,
        X=None,
        y=None,
        input_is_packed: bool | None = None,
        n_features: int | None = None,
    ) -> "BitBirch":
        if X is None:
            raise ValueError()
        return self.fit(
            X, input_is_packed=input_is_packed, n_features=n_features
        )

    def fit_predict(  # type: ignore[override]
        self,
        X,
        y=None,
        input_is_packed: bool | None = None,
        n_features: int | None = None,
    ) -> NDArray[np.integer]:
        self.fit(X, input_is_packed=input_is_packed, n_features=n_features)
        if not self.compute_labels:
            self.labels_ = self.get_assignments()
        return self.labels_

    # -- inference --

    def _query_matrix(
        self, X, input_is_packed: bool | None, n_features: int | None
    ) -> tuple[NDArray[np.bool_], NDArray[np.bool_]]:
        r"""(validated query rows, fitted centroids) as boolean bit views."""
        check_is_fitted(self)
        X = validate_data(self, X, accept_sparse="csr", reset=False)
        if self._resolve_packed(input_is_packed):
            X = unpack_fingerprints(X, n_features=n_features)
        query = X.astype(np.uint8, copy=False).view(np.bool_)
        centers = self.subcluster_centers_.astype(np.uint8, copy=False)
        return query, centers.view(np.bool_)

    def predict(  # type: ignore[override]
        self,
        X,
        input_is_packed: bool | None = None,
        n_features: int | None = None,
    ) -> NDArray[np.integer]:
        r"""Label of the nearest (Jaccard) subcluster centroid per row."""
        query, centers = self._query_matrix(X, input_is_packed, n_features)
        nearest = pairwise_distances_argmin(query, centers, metric="jaccard")
        return self.subcluster_labels_[nearest]

    def transform(  # type: ignore[override]
        self,
        X,
        input_is_packed: bool | None = None,
        n_features: int | None = None,
    ):
        r"""Jaccard distance of every row to every subcluster centroid."""
        query, centers = self._query_matrix(X, input_is_packed, n_features)
        return pairwise_distances(query, centers, metric="jaccard")

    def __sklearn_tags__(self):  # type: ignore[override]
        tags = super().__sklearn_tags__()
        tags.input_tags.sparse = True
        return tags


class UnpackedBitBirch(BitBirch):
    r"""``BitBirch`` whose inputs default to *unpacked* 0/1 fingerprints."""

    _packed_by_default = False
