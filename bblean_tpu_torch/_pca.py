r"""Principal component analysis as scikit-learn 1.9.0 computes it.

The part of ``sklearn.decomposition.PCA`` that ``plotting.py`` reaches,
copied so that the plots' embeddings need no scikit-learn:
``PCA(n_components, random_state=seed).fit_transform(X)`` on a dense array
with the default ``svd_solver="auto"``, no whitening.  It keeps
scikit-learn's solver policy (``PCA._fit``), its three dense solvers
(``"covariance_eigh"`` and ``"full"`` of ``PCA._fit_full``;
``"randomized"`` of ``PCA._fit_truncated`` through
``sklearn.utils.extmath._randomized_svd`` and
``_randomized_range_finder``, with the ``n_iter`` and
``power_iteration_normalizer`` defaults and the normal draws of a
``numpy.random.RandomState`` seeded with ``random_state``), and
``svd_flip`` with the sign rule PCA applies (``u_based_decision=False``:
the largest loading of each component is positive).  float32 input is worked in float32, float64 in float64,
anything else becomes float64, as scikit-learn's input check does; the
linear algebra is ``scipy.linalg`` and NumPy on the host, as there.  So
the result equals scikit-learn's up to the rounding of the BLAS it runs on.

scikit-learn is distributed under the BSD 3-Clause License, whose notice
is kept here with the copied code:

    Copyright (c) 2007-2026 The scikit-learn developers.
    All rights reserved.

    Redistribution and use in source and binary forms, with or without
    modification, are permitted provided that the following conditions are
    met:

    * Redistributions of source code must retain the above copyright
      notice, this list of conditions and the following disclaimer.

    * Redistributions in binary form must reproduce the above copyright
      notice, this list of conditions and the following disclaimer in the
      documentation and/or other materials provided with the distribution.

    * Neither the name of the copyright holder nor the names of its
      contributors may be used to endorse or promote products derived from
      this software without specific prior written permission.

    THIS SOFTWARE IS PROVIDED BY THE COPYRIGHT HOLDERS AND CONTRIBUTORS "AS
    IS" AND ANY EXPRESS OR IMPLIED WARRANTIES, INCLUDING, BUT NOT LIMITED
    TO, THE IMPLIED WARRANTIES OF MERCHANTABILITY AND FITNESS FOR A
    PARTICULAR PURPOSE ARE DISCLAIMED. IN NO EVENT SHALL THE COPYRIGHT
    HOLDER OR CONTRIBUTORS BE LIABLE FOR ANY DIRECT, INDIRECT, INCIDENTAL,
    SPECIAL, EXEMPLARY, OR CONSEQUENTIAL DAMAGES (INCLUDING, BUT NOT LIMITED
    TO, PROCUREMENT OF SUBSTITUTE GOODS OR SERVICES; LOSS OF USE, DATA, OR
    PROFITS; OR BUSINESS INTERRUPTION) HOWEVER CAUSED AND ON ANY THEORY OF
    LIABILITY, WHETHER IN CONTRACT, STRICT LIABILITY, OR TORT (INCLUDING
    NEGLIGENCE OR OTHERWISE) ARISING IN ANY WAY OUT OF THE USE OF THIS
    SOFTWARE, EVEN IF ADVISED OF THE POSSIBILITY OF SUCH DAMAGE.
"""

from __future__ import annotations

import numpy as np
from numpy.typing import NDArray
from scipy import linalg

__all__ = ["PCA"]


def svd_flip(
    u: NDArray[np.floating] | None, v: NDArray[np.floating]
) -> tuple[NDArray[np.floating] | None, NDArray[np.floating]]:
    r"""``svd_flip(u, v, u_based_decision=False)``: each row of ``v`` (and
    column of ``u``) flipped so that its largest absolute entry is
    positive."""
    max_abs_v_rows = np.argmax(np.abs(v), axis=1)
    shift = np.arange(v.shape[0])
    indices = max_abs_v_rows + shift * v.shape[1]
    signs = np.sign(np.take(np.reshape(v, (-1,)), indices, axis=0))
    if u is not None:
        u *= signs[np.newaxis, :]
    v *= signs[:, np.newaxis]
    return u, v


def _randomized_range_finder(
    a: NDArray[np.floating], size: int, n_iter: int, random_state: np.random.RandomState
) -> NDArray[np.floating]:
    r"""An orthonormal basis of ``a``'s approximate range: ``n_iter`` power
    iterations normalized by LU (none when ``n_iter <= 2``), then QR."""
    q = random_state.normal(size=(a.shape[1], size))
    if a.dtype == np.float32:
        q = q.astype(np.float32, copy=False)
    if n_iter <= 2:
        def normalizer(x):
            return x, None
    else:
        def normalizer(x):
            return linalg.lu(x, permute_l=True, check_finite=False)
    for _ in range(n_iter):
        q, _ = normalizer(a @ q)
        q, _ = normalizer(a.T @ q)
    q, _ = linalg.qr(a @ q, mode="economic", check_finite=False)
    return q


def _randomized_svd(
    m: NDArray[np.floating],
    n_components: int,
    random_state: np.random.RandomState,
    n_oversamples: int = 10,
) -> tuple[NDArray[np.floating], NDArray[np.floating], NDArray[np.floating]]:
    r"""``_randomized_svd(m, n_components, n_iter="auto",
    power_iteration_normalizer="auto", transpose="auto", flip_sign=False)``."""
    n_random = n_components + n_oversamples
    n_samples, n_features = m.shape
    n_iter = 7 if n_components < 0.1 * min(m.shape) else 4
    transpose = n_samples < n_features
    if transpose:
        m = m.T
    q = _randomized_range_finder(m, n_random, n_iter, random_state)
    b = q.T @ m
    uhat, s, vt = linalg.svd(b, full_matrices=False, lapack_driver="gesdd")
    del b
    u = q @ uhat
    if transpose:
        return vt[:n_components, :].T, s[:n_components], u[:, :n_components].T
    return u[:, :n_components], s[:n_components], vt[:n_components, :]


class PCA:
    r"""``sklearn.decomposition.PCA(n_components, random_state=...)``'s
    ``fit_transform`` on dense input; the solver is picked as scikit-learn
    picks it and is kept in ``fit_svd_solver_``."""

    def __init__(self, n_components: int | None = None, *, random_state: int | None = None) -> None:
        self.n_components = n_components
        self.random_state = random_state

    def fit_transform(self, x: NDArray) -> NDArray[np.floating]:
        x = np.asarray(x)
        if x.dtype not in (np.float64, np.float32):
            x = x.astype(np.float64)
        if x.ndim != 2:
            raise ValueError(f"PCA needs a 2-D array, got shape {x.shape}")
        n_samples, n_features = x.shape
        n_components = min(x.shape) if self.n_components is None else self.n_components
        if n_features <= 1_000 and n_samples >= 10 * n_features:
            solver = "covariance_eigh"
        elif max(x.shape) <= 500:
            solver = "full"
        elif 1 <= n_components < 0.8 * min(x.shape):
            solver = "randomized"
        else:
            solver = "full"
        self.fit_svd_solver_ = solver
        if not 0 <= n_components <= min(n_samples, n_features):
            raise ValueError(
                f"n_components={n_components} must be between 0 and "
                f"min(n_samples, n_features)={min(x.shape)} with svd_solver={solver!r}"
            )
        self.mean_ = np.mean(x, axis=0)
        if solver == "covariance_eigh":
            # The covariance is centred after the product; the data is
            # projected first and centred after
            c = x.T @ x
            c -= n_samples * np.reshape(self.mean_, (-1, 1)) * np.reshape(self.mean_, (1, -1))
            c /= n_samples - 1
            _eigenvals, eigenvecs = np.linalg.eigh(c)
            eigenvecs = np.flip(eigenvecs, axis=1)  # largest eigenvalue first
            _, vt = svd_flip(None, eigenvecs.T)
            self.components_ = np.asarray(vt[:n_components, :], copy=True)
            out = x @ self.components_.T
            out -= np.reshape(self.mean_, (1, -1)) @ self.components_.T
            return out
        x_centered = np.array(x, copy=True)
        x_centered -= self.mean_
        if solver == "full":
            u, s, vt = linalg.svd(x_centered, full_matrices=False)
        else:
            u, s, vt = _randomized_svd(
                x_centered, n_components, np.random.RandomState(self.random_state)
            )
        u, vt = svd_flip(u, vt)
        self.components_ = np.asarray(vt[:n_components, :], copy=True)
        u = u[:, :n_components]
        u *= s[:n_components]
        return u
