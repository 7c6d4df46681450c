r"""t-SNE for cluster visualization on a torch device.

Port of ``bblean_tpu/ops/tsne.py``.  The plotting path embeds the *top
clusters'* fingerprints (thousands of points, not millions), where the
exact O(N^2) gradient is small enough to run entirely on the device:
pairwise distances and the attraction/repulsion terms are matrix products,
the per-point perplexity calibration is a vectorized bisection, and the
descent is a loop of tensor ops with no host read inside.

Same surface as the JAX function: perplexity, seed, PCA init, second-phase
exaggeration, multiscale affinities (perplexity mixture), and the
t-distribution ``dof`` knob.  With ``do_pca_init=True`` nothing is drawn at
random (the init is a numpy SVD on the host), so the two packages can be
compared number by number over a few iterations; the seeded-normal init
comes from numpy's generator, as in the JAX function.
"""

from __future__ import annotations

import numpy as np
import torch

from bblean_tpu_torch._device import DeviceLike, require_device

__all__ = ["tsne_embed"]


def _pairwise_sq_dists(x: torch.Tensor) -> torch.Tensor:
    sq = (x * x).sum(dim=1)
    d2 = sq[:, None] - 2.0 * (x @ x.t()) + sq[None, :]
    return d2.clamp_min(0.0)


def _calibrate_rows(d2: torch.Tensor, perplexity: float, iters: int = 50) -> torch.Tensor:
    r"""Per-row conditional affinities P(j|i) at the target perplexity via
    vectorized bisection over the precision beta."""
    n = d2.shape[0]
    dev = d2.device
    target = float(np.log(np.float32(perplexity)))
    eye = torch.eye(n, dtype=torch.bool, device=dev)

    def entropy_and_p(beta):
        w = torch.exp(-d2 * beta[:, None])
        w = w.masked_fill(eye, 0.0)
        sum_w = w.sum(dim=1).clamp_min(1e-12)
        p = w / sum_w[:, None]
        # Shannon entropy H = log(sum_w) + beta * <d2>_p
        h = torch.log(sum_w) + beta * (d2 * p).sum(dim=1)
        return h, p

    beta = torch.ones(n, dtype=torch.float32, device=dev)
    lo = torch.zeros(n, dtype=torch.float32, device=dev)
    hi = torch.full((n,), torch.inf, dtype=torch.float32, device=dev)
    for _ in range(iters):
        h, _ = entropy_and_p(beta)
        too_high = h > target  # entropy too high -> raise beta
        lo = torch.where(too_high, beta, lo)
        hi = torch.where(too_high, hi, beta)
        beta = torch.where(torch.isinf(hi), beta * 2.0, (lo + hi) * 0.5)
    _, p = entropy_and_p(beta)
    return p


def _descend(
    p: torch.Tensor, y0: torch.Tensor, n_iter: int, exaggeration: float,
    early_exag: float, early_iter: int, learning_rate: float, dof: float,
) -> torch.Tensor:
    r"""Gradient descent with early exaggeration, gains and momentum."""
    n = y0.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=y0.device)
    a = (dof + 1.0) / 2.0

    def grad(y, exag):
        d2 = _pairwise_sq_dists(y)
        w = (1.0 + d2 / dof) ** (-a)  # student-t kernel
        w = w.masked_fill(eye, 0.0)
        z = w.sum().clamp_min(1e-12)
        q = w / z
        mult = (exag * p - q) * w ** (1.0 / a)  # (P-Q) * (1+d2/dof)^-1
        # dC/dy_i = 4 * sum_j mult_ij (y_i - y_j)
        row = mult.sum(dim=1)
        return 4.0 * (row[:, None] * y - mult @ y)

    y, vel, gains = y0, torch.zeros_like(y0), torch.ones_like(y0)
    for i in range(n_iter):
        early = i < early_iter
        g = grad(y, early_exag if early else exaggeration)
        same_sign = torch.sign(g) == torch.sign(vel)
        gains = torch.where(same_sign, gains * 0.8, gains + 0.2).clamp_min(0.01)
        vel = (0.5 if early else 0.8) * vel - learning_rate * gains * g
        y = y + vel
    return y - y.mean(dim=0)


def tsne_embed(
    x: np.ndarray,
    *,
    perplexity: float = 30.0,
    n_iter: int = 750,
    exaggeration: float | None = None,
    early_exaggeration: float = 12.0,
    early_iter: int = 250,
    seed: int | None = 42,
    do_pca_init: bool = True,
    multiscale: bool = False,
    dof: float = 1.0,
    device: DeviceLike = "cuda",
) -> np.ndarray:
    r"""2-D t-SNE embedding of ``x`` (N, F), computed on ``device``.

    ``multiscale`` mixes the target perplexity with ``N/100`` (the
    reference's openTSNE multiscale recipe).  ``exaggeration`` is the
    second-phase exaggeration (None = 1).
    """
    dev = require_device(device)
    x = np.asarray(x, dtype=np.float32)
    n = len(x)
    if n < 3:
        raise ValueError("t-SNE needs at least 3 points")
    perplexity = float(min(perplexity, max((n - 1) / 3.0, 2.0)))

    d2 = _pairwise_sq_dists(torch.from_numpy(x).to(dev))
    p_cond = _calibrate_rows(d2, perplexity)
    if multiscale:
        p2 = _calibrate_rows(d2, max(min(n / 100.0, (n - 1) / 3.0), 2.0))
        p_cond = 0.5 * (p_cond + p2)
    p = (p_cond + p_cond.t()) / (2.0 * n)

    if do_pca_init:
        xc = x - x.mean(0)
        # Deterministic PCA init scaled to std 1e-4 (openTSNE convention)
        _u, _s, vt = np.linalg.svd(xc, full_matrices=False)
        init = xc @ vt[:2].T
        init = init / max(np.std(init[:, 0]), 1e-12) * 1e-4
    else:
        rng = np.random.default_rng(seed)
        init = rng.normal(scale=1e-4, size=(n, 2))
    y0 = torch.from_numpy(np.asarray(init, dtype=np.float32)).to(dev)

    y = _descend(
        p, y0, n_iter,
        float(exaggeration) if exaggeration is not None else 1.0,
        early_exaggeration, early_iter,
        learning_rate=max(n / early_exaggeration, 50.0),
        dof=float(dof),
    )
    return y.cpu().numpy()
