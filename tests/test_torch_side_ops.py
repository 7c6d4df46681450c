r"""The port's side-path ops (popcount, Tanimoto, k-means, t-SNE) against
the JAX package's, both on the CPU, on inputs made with numpy from a seed.

Tolerances: integers equal; f32 Tanimoto bit for bit (both divide the same
exact integers in f32); k-means by partition (its random draws cannot be
shared between the packages), Lloyd steps from given centres with equal
labels and centres to 1e-5; t-SNE affinities to 1e-5 of the largest entry
and 10 descent steps to 1e-3 of the embedding's scale (the descent
amplifies rounding: see ``test_descent_steps_equal_jax``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bblean_tpu.fingerprints import make_fake_fingerprints
from bblean_tpu.ops import kmeans as jkm, popcount as jpc, tanimoto as jtan, tsne as jtsne
from bblean_tpu_torch import ops as tops
from bblean_tpu_torch.ops import kmeans as tkm, popcount as tpc, tanimoto as ttan, tsne as ttsne

SEED = 17408390758220920002


def _bits(rows: int, width: int, seed: int) -> np.ndarray:
    return (np.random.default_rng(seed).random((rows, width)) < 0.35).astype(np.uint8)


# -- popcount and Tanimoto -------------------------------------------------------


@pytest.mark.parametrize("shape", [(16, 256), (5, 33), (3, 4, 13), (1, 1)])
def test_popcount_device_equals_jax(shape) -> None:
    packed = np.random.default_rng(sum(shape)).integers(0, 256, shape, dtype=np.uint8)
    got = tpc.popcount_device(packed, device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jpc.popcount_device(packed)))
    # A tensor is counted where it lies
    np.testing.assert_array_equal(tpc.popcount_device(torch.from_numpy(packed)).numpy(), got.numpy())
    np.testing.assert_array_equal(
        got.numpy(), np.unpackbits(packed, axis=-1).sum(-1)
    )


@pytest.mark.parametrize("width", [2048, 100, 13])
def test_popcount_rows_equals_jax(width) -> None:
    bits = _bits(16, width, width)
    got = tpc.popcount_rows(bits, device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jpc.popcount_rows(bits)))


def test_popcount_device_rejects_other_dtypes() -> None:
    with pytest.raises(ValueError, match="uint8"):
        tpc.popcount_device(np.zeros((2, 4), np.int32), device="cpu")


@pytest.mark.parametrize("n_features", [2048, 264, 104])
def test_tanimoto_packed_arr_vec_bit_equal_to_jax(n_features) -> None:
    fps = make_fake_fingerprints(64, n_features=n_features, seed=SEED)
    fps[5] = 0  # an empty row: union clamps to 1
    for probe in (fps[0], fps[5]):
        got = ttan.tanimoto_packed_arr_vec(fps, probe, device="cpu")
        ref = np.asarray(jtan.tanimoto_packed_arr_vec(fps, probe))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize(
    "n,c,width", [(48, 48, 2048), (5, 3, 13), (17, 9, 100), (40, 1, 2047), (1, 30, 24)]
)
def test_intersection_and_tanimoto_matmul_equal_jax(n, c, width) -> None:
    r"""Rows under ``torch._int_mm``'s 17-row floor and widths that are no
    multiple of 8 or 16 are padded with zeros, which add nothing."""
    q, cent = _bits(n, width, n + width), _bits(c, width, c + width + 1)
    q[0] = 0
    inter = ttan.intersection_matmul(q, cent, device="cpu")
    assert inter.dtype == torch.int32 and inter.shape == (n, c)
    np.testing.assert_array_equal(inter.numpy(), np.asarray(jtan.intersection_matmul(q, cent)))
    np.testing.assert_array_equal(inter.numpy(), q.astype(np.int64) @ cent.astype(np.int64).T)

    ref = np.asarray(jtan.tanimoto_matmul(q, cent))
    got = ttan.tanimoto_matmul(q, cent, device="cpu")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)
    # Popcounts handed in, tensors where they lie
    qt, ct = torch.from_numpy(q), torch.from_numpy(cent)
    got = ttan.tanimoto_matmul(
        qt, ct, qt.sum(-1, dtype=torch.int32), ct.sum(-1, dtype=torch.int32)
    )
    np.testing.assert_array_equal(got.numpy(), ref)


def test_counts_past_bf16_are_exact() -> None:
    r"""Counts above 256 are not representable in bf16; the int8 product
    holds them."""
    q = np.ones((3, 2048), np.uint8)
    inter = ttan.intersection_matmul(q, q, device="cpu")
    assert (inter.numpy() == 2048).all()


def test_ops_package_exports_what_the_jax_package_exports() -> None:
    import bblean_tpu.ops as jops

    assert sorted(tops.__all__) == sorted(jops.__all__)
    for name in tops.__all__:
        assert callable(getattr(tops, name))


def test_numpy_input_without_a_card_raises() -> None:
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is available")
    bits = _bits(4, 16, 0)
    for call in (
        lambda: tpc.popcount_rows(bits),
        lambda: ttan.tanimoto_matmul(bits, bits),
        lambda: tkm.kmeans_fit_predict(bits, 2),
        lambda: ttsne.tsne_embed(bits.astype(np.float32)),
    ):
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            call()


# -- k-means ---------------------------------------------------------------------


def _blobs(seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(4, 64)) * 10.0
    return np.concatenate(
        [c + rng.normal(size=(50, 64)) for c in centers]
    ).astype(np.float32)


def _same_partition(a: np.ndarray, b: np.ndarray) -> bool:
    pairs = set(zip(a.tolist(), b.tolist()))
    return len(pairs) == len(set(a.tolist())) == len(set(b.tolist()))


def test_kmeans_blobs_partition_equals_jax() -> None:
    pts = _blobs()
    labels = tkm.kmeans_fit_predict(pts, 4, seed=1, device="cpu")
    assert labels.shape == (200,) and labels.dtype == np.int64
    assert set(labels.tolist()) == {0, 1, 2, 3}
    for b in range(4):
        assert len(set(labels[b * 50 : (b + 1) * 50].tolist())) == 1
    assert _same_partition(labels, jkm.kmeans_fit_predict(pts, 4, seed=1))
    # The same labels on two calls with one seed
    assert (tkm.kmeans_fit_predict(pts, 4, seed=1, device="cpu") == labels).all()


def test_kmeans_errors_and_single_cluster() -> None:
    pts = _blobs()
    with pytest.raises(ValueError):
        tkm.kmeans_fit_predict(pts, 0, device="cpu")
    with pytest.raises(ValueError):
        tkm.kmeans_fit_predict(pts, 201, device="cpu")
    one = tkm.kmeans_fit_predict(pts, 1, device="cpu")
    assert one.dtype == np.int64 and (one == 0).all()


def _jax_lloyd(x, centers, n_iters):
    r"""The Lloyd loop of ``bblean_tpu/ops/kmeans.py`` from given centres."""
    import jax

    n, k = x.shape[0], centers.shape[0]
    x_sq = jnp.sum(x * x, axis=-1)
    for _ in range(n_iters):
        labels = jnp.argmin(jkm._sq_dists(x, centers, x_sq), axis=-1)
        sums = jax.ops.segment_sum(x, labels, num_segments=k)
        counts = jax.ops.segment_sum(jnp.ones((n,), jnp.float32), labels, num_segments=k)
        centers = jnp.where(
            (counts > 0)[:, None], sums / jnp.maximum(counts, 1.0)[:, None], centers
        )
    return jnp.argmin(jkm._sq_dists(x, centers, x_sq), axis=-1), centers


@pytest.mark.parametrize("data", ["blobs", "bits"])
def test_lloyd_steps_from_given_centres_equal_jax(data, monkeypatch) -> None:
    r"""Labels equal, centres to 1e-5; one centre starts far from every
    point, so its cluster is empty and it must stay where it is.  Small row
    chunks make the port's chunked sums run over several chunks."""
    monkeypatch.setattr(tkm, "_CHUNK_CELLS", 6 * 64)
    rng = np.random.default_rng(3)
    x = _blobs(2) if data == "blobs" else _bits(300, 96, 4).astype(np.float32)
    centers = x[rng.choice(len(x), 6, replace=False)].copy()
    centers[5] = 1e3
    ref_labels, ref_centers = _jax_lloyd(jnp.asarray(x), jnp.asarray(centers), 5)
    xt, ct = torch.from_numpy(x), torch.from_numpy(centers)
    x_sq = (xt * xt).sum(-1)
    for _ in range(5):
        ct = tkm._lloyd_step(xt, ct, x_sq)
    labels = tkm._assign(xt, ct, x_sq)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(ref_labels))
    np.testing.assert_allclose(ct.numpy(), np.asarray(ref_centers), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(ct[5].numpy(), centers[5])


def _inertia(x: np.ndarray, labels: np.ndarray) -> float:
    total = 0.0
    for lab in np.unique(labels):
        members = x[labels == lab].astype(np.float64)
        total += ((members - members.mean(0)) ** 2).sum()
    return total


def test_kmeans_inertia_on_bits_close_to_jax() -> None:
    r"""Random 0/1 rows have no clear partition, so the two packages' draws
    lead to different local optima: mean inertia over 5 seeds within 5%."""
    x = _bits(400, 128, 9).astype(np.float32)
    got = [_inertia(x, tkm.kmeans_fit_predict(x, 12, seed=s, device="cpu")) for s in range(5)]
    ref = [_inertia(x, jkm.kmeans_fit_predict(x, 12, seed=s)) for s in range(5)]
    assert abs(np.mean(got) - np.mean(ref)) <= 0.05 * np.mean(ref)
    for s in range(5):
        labels = tkm.kmeans_fit_predict(x, 12, seed=s, device="cpu")
        assert labels.min() >= 0 and labels.max() < 12


def test_kmeans_seed_changes_the_draws() -> None:
    x = _bits(200, 64, 1).astype(np.float32)
    a = tkm.kmeans_fit_predict(x, 8, seed=0, n_iters=0, device="cpu")
    b = tkm.kmeans_fit_predict(x, 8, seed=1, n_iters=0, device="cpu")
    assert not _same_partition(a, b)


# -- t-SNE -----------------------------------------------------------------------


def _tsne_blobs(n_per: int = 60, n_blobs: int = 4, dim: int = 64, seed: int = 0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=8.0, size=(n_blobs, dim))
    pts = np.concatenate(
        [c + rng.normal(scale=0.5, size=(n_per, dim)) for c in centers]
    )
    return pts.astype(np.float32), np.repeat(np.arange(n_blobs), n_per)


def _separation_score(emb: np.ndarray, labels: np.ndarray) -> float:
    d2 = ((emb[:, None] - emb[None, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    return float((labels[d2.argmin(1)] == labels).mean())


def test_pairwise_sq_dists_equal_jax() -> None:
    r"""``sq_i - 2 x_i.x_j + sq_j`` cancels: the two packages' products
    round differently, so distances agree to a few ulp of the largest
    squared norm, not of the distance."""
    pts, _ = _tsne_blobs(n_per=30)
    ref = np.asarray(jtsne._pairwise_sq_dists(jnp.asarray(pts)))
    got = ttsne._pairwise_sq_dists(torch.from_numpy(pts)).numpy()
    ulp = np.spacing(np.float32((pts * pts).sum(1).max()))
    assert np.abs(got - ref).max() <= 8 * ulp
    assert (got >= 0).all()


@pytest.mark.parametrize("perplexity", [20.0, 2.0])
def test_calibrated_affinities_equal_jax(perplexity) -> None:
    r"""From the same distances, P(j|i) to 1e-5 of the largest entry; at
    perplexity 20 the rows sum to 1 at the target perplexity (at 2, rows
    whose nearest neighbours are much closer than the rest end the bisection
    with underflowed weights, in both packages)."""
    pts, _ = _tsne_blobs(n_per=30)
    d2 = np.array(jtsne._pairwise_sq_dists(jnp.asarray(pts)))
    ref = np.asarray(jtsne._calibrate_rows(jnp.asarray(d2), perplexity))
    got = ttsne._calibrate_rows(torch.from_numpy(d2), perplexity).numpy()
    assert np.abs(got - ref).max() <= 1e-5 * ref.max()
    assert (np.diag(got) == 0).all()
    if perplexity == 20.0:
        np.testing.assert_allclose(got.sum(1), 1.0, atol=1e-5)
        entropy = -(got * np.log(np.maximum(got, 1e-30))).sum(1)
        np.testing.assert_allclose(np.exp(entropy), perplexity, rtol=1e-3)


def _fps_points(num: int = 120) -> np.ndarray:
    return make_fake_fingerprints(num, n_features=256, seed=3, pack=False).astype(np.float32)


@pytest.mark.parametrize("dof,exag", [(1.0, 1.0), (0.8, 1.5)])
def test_descent_steps_equal_jax(dof, exag) -> None:
    r"""``_descend`` from the same affinities and the same start.  The
    descent amplifies rounding (the embedding grows from 1e-4 to tens of
    units in five steps at this learning rate, and the gains switch on the
    gradient's sign), so the distance between two correct f32
    implementations grows about tenfold every three steps: 1e-6 of the
    embedding's scale after 1 step, 1e-4 after 5, 1e-3 after 10; by 20 the
    two have parted, as any two runs that differ in one rounding do."""
    pts = _fps_points()
    n = len(pts)
    d2 = jtsne._pairwise_sq_dists(jnp.asarray(pts))
    p_cond = np.asarray(jtsne._calibrate_rows(d2, 15.0))
    p = ((p_cond + p_cond.T) / (2.0 * n)).astype(np.float32)
    y0 = (np.random.default_rng(0).normal(size=(n, 2)) * 1e-4).astype(np.float32)
    for steps, tol in ((1, 1e-6), (5, 1e-4), (10, 1e-3)):
        args = (steps, exag, 12.0, 4, 50.0, dof)  # early phase: 4 steps
        ref = np.asarray(jtsne._descend(jnp.asarray(p), jnp.asarray(y0), *args))
        got = ttsne._descend(torch.from_numpy(p), torch.from_numpy(y0), *args).numpy()
        assert np.abs(got - ref).max() <= tol * np.abs(ref).max(), steps


@pytest.mark.parametrize(
    "knobs",
    [
        dict(perplexity=15.0),
        dict(perplexity=10.0, multiscale=True, dof=0.8, exaggeration=1.5, early_iter=5),
    ],
    ids=["defaults", "multiscale-dof"],
)
def test_embedding_after_10_iterations_equals_jax(knobs) -> None:
    r"""The whole function with the PCA init (nothing is random): 10
    iterations agree to 1e-3 of the embedding's scale (its largest
    coordinate); see :func:`test_descent_steps_equal_jax` for why not more
    iterations."""
    pts = _fps_points()
    ref = jtsne.tsne_embed(pts, n_iter=10, **knobs)
    got = ttsne.tsne_embed(pts, n_iter=10, device="cpu", **knobs)
    assert got.shape == ref.shape == (120, 2) and got.dtype == np.float32
    assert np.abs(got - ref).max() <= 1e-3 * np.abs(ref).max()


def test_tsne_separates_blobs() -> None:
    pts, labels = _tsne_blobs()
    emb = ttsne.tsne_embed(pts, perplexity=20, n_iter=400, seed=1, device="cpu")
    assert emb.shape == (len(pts), 2)
    assert np.isfinite(emb).all()
    assert _separation_score(emb, labels) > 0.95


def test_tsne_multiscale_and_knobs() -> None:
    pts, labels = _tsne_blobs(n_per=40, n_blobs=3)
    emb = ttsne.tsne_embed(
        pts, perplexity=15, n_iter=300, multiscale=True, exaggeration=1.5,
        dof=0.8, do_pca_init=False, seed=3, device="cpu",
    )
    assert emb.shape == (len(pts), 2)
    assert _separation_score(emb, labels) > 0.9


def test_tsne_deterministic() -> None:
    pts, _ = _tsne_blobs(n_per=30, n_blobs=3)
    for init in (True, False):
        a = ttsne.tsne_embed(pts, n_iter=100, seed=5, do_pca_init=init, device="cpu")
        b = ttsne.tsne_embed(pts, n_iter=100, seed=5, do_pca_init=init, device="cpu")
        np.testing.assert_array_equal(a, b)


def test_tsne_rejects_tiny_input() -> None:
    with pytest.raises(ValueError):
        ttsne.tsne_embed(np.zeros((2, 8), np.float32), device="cpu")
