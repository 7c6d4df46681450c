r"""k-means over cluster centroids (global clustering) on a torch device.

Port of ``bblean_tpu/ops/kmeans.py``: k-means++ seeding (each next centre
drawn with probability proportional to the squared distance to the nearest
one so far, by Gumbel-max over ``log(min_d)``) and ``n_iters`` Lloyd steps;
an empty cluster keeps its centre.

Random draws and the device.  ``jax.random``'s streams cannot be reproduced
by a torch generator, so a seed does not give the labels the JAX package
gives; the port is held to JAX by partition quality, not draw by draw.
Within the port every draw comes from one CPU ``torch.Generator`` seeded
with ``seed`` and is then moved to the device, so the CPU and a CUDA device
see the same draws.  Their labels are equal wherever f32 rounding decides
no comparison: the two devices sum products in different orders, so a near
tie in an argmax or argmin may fall differently, and later steps then
differ.  Two calls with one seed on one device give the same labels: the
centre update is a one-hot matrix product, not an atomic scatter-add.

TF32 stays off for the distance product: ``x_sq - 2 x.c + c_sq`` cancels.
"""

from __future__ import annotations

import numpy as np
import torch

from bblean_tpu_torch._device import DeviceLike, require_device

__all__ = ["kmeans_fit_predict"]

# Rows of one Lloyd chunk times clusters: bounds the (rows, K) distance and
# one-hot matrices
_CHUNK_CELLS = 1 << 26


def _matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    r"""``a @ b`` in full f32, whatever the process-wide TF32 setting."""
    if a.device.type != "cuda":
        return a @ b
    allowed = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return a @ b
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allowed


def _sq_dists(x: torch.Tensor, c: torch.Tensor, x_sq: torch.Tensor) -> torch.Tensor:
    r"""Squared euclidean distances (N, K) via one matrix product."""
    prod = _matmul_f32(x, c.t())
    c_sq = (c * c).sum(dim=-1)
    return (x_sq[:, None] - 2.0 * prod + c_sq[None, :]).clamp_min(0.0)


def _seed_centers(
    x: torch.Tensor, n_clusters: int, gen: torch.Generator
) -> torch.Tensor:
    r"""k-means++ seeding; the draws come from the CPU generator ``gen``."""
    n, d = x.shape
    first = int(torch.randint(n, (), generator=gen))
    centers = torch.zeros((n_clusters, d), dtype=torch.float32, device=x.device)
    centers[0] = x[first]
    min_d = ((x - x[first][None, :]) ** 2).sum(dim=-1)
    tiny = torch.finfo(torch.float32).tiny
    for i in range(1, n_clusters):
        u = torch.rand(n, generator=gen).clamp_min(tiny).to(x.device)
        # Gumbel-max categorical over log(min_d): robust when mass collapses
        logits = torch.log(min_d.clamp_min(1e-30))
        pick = torch.argmax(logits - torch.log(-torch.log(u)))
        c = x[pick]
        centers[i] = c
        min_d = torch.minimum(min_d, ((x - c[None, :]) ** 2).sum(dim=-1))
    return centers


def _assign(x: torch.Tensor, centers: torch.Tensor, x_sq: torch.Tensor) -> torch.Tensor:
    r"""Nearest centre per row (first on ties), in row chunks."""
    n, k = x.shape[0], centers.shape[0]
    step = max(1, _CHUNK_CELLS // k)
    return torch.cat([
        torch.argmin(_sq_dists(x[s : s + step], centers, x_sq[s : s + step]), dim=-1)
        for s in range(0, n, step)
    ])


def _lloyd_step(
    x: torch.Tensor, centers: torch.Tensor, x_sq: torch.Tensor
) -> torch.Tensor:
    r"""One Lloyd step: assign, then move each non-empty cluster's centre to
    its members' mean.  The sums are one-hot matrix products over row
    chunks, so their order of addition is fixed."""
    n, k = x.shape[0], centers.shape[0]
    labels = _assign(x, centers, x_sq)
    sums = torch.zeros_like(centers)
    step = max(1, _CHUNK_CELLS // k)
    for s in range(0, n, step):
        onehot = torch.nn.functional.one_hot(labels[s : s + step], k).to(torch.float32)
        sums += _matmul_f32(onehot.t(), x[s : s + step])
    counts = torch.bincount(labels, minlength=k).to(torch.float32)
    # Empty clusters keep their previous center
    return torch.where(
        (counts > 0)[:, None], sums / counts.clamp_min(1.0)[:, None], centers
    )


def _kmeans_impl(
    x: torch.Tensor, gen: torch.Generator, *, n_clusters: int, n_iters: int
) -> tuple[torch.Tensor, torch.Tensor]:
    x_sq = (x * x).sum(dim=-1)
    centers = _seed_centers(x, n_clusters, gen)
    for _ in range(n_iters):
        centers = _lloyd_step(x, centers, x_sq)
    return _assign(x, centers, x_sq).to(torch.int32), centers


def kmeans_fit_predict(
    points: np.ndarray,
    n_clusters: int,
    *,
    n_iters: int = 50,
    seed: int = 0,
    device: DeviceLike = "cuda",
) -> np.ndarray:
    r"""Cluster ``points`` into ``n_clusters``; returns 0-based labels.

    k-means++ seeding + ``n_iters`` Lloyd steps on ``device``.
    """
    dev = require_device(device)
    if n_clusters < 1:
        raise ValueError("n_clusters must be >= 1")
    if n_clusters == 1:
        return np.zeros(len(points), dtype=np.int64)
    if n_clusters > len(points):
        raise ValueError("n_clusters exceeds the number of points")
    x = torch.from_numpy(np.ascontiguousarray(points, dtype=np.float32)).to(dev)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    labels, _ = _kmeans_impl(x, gen, n_clusters=n_clusters, n_iters=n_iters)
    return labels.cpu().numpy().astype(np.int64)
