r"""The port's plotting module against the JAX package's, on the CPU.

The embeddings the JAX plots draw are caught at ``_embed_and_scatter``:
the port's ``pca_embedding`` equals JAX's ``pca_plot`` input (both PCAs are
scikit-learn 1.9.0's algorithm; ``atol`` = 1e-6 of the embedding's scale),
and ``tsne_embedding(device="cpu")`` equals JAX's ``tsne_plot`` input after
1, 5 and 10 descent steps: the same PCA to 50 components (equal bit for
bit here) and perplexity clamp, then each package's exact t-SNE in
float32.  The descent amplifies the two libraries' different rounding of
their reductions about tenfold every two steps once the embedding has
grown (measured here, over the embedding's largest absolute value: 1.3e-6
and 1.1e-6 after 1 step, 6.0e-6 and 1.6e-5 after 5, 6.9e-4 and 3.0e-3
after 10, 2.4e-3 and 0.17 after 15, for the default and the multiscale
knobs), so the tolerance is ``atol`` = 1e-5, 1e-4 and 1e-2 of that value
after 1, 5 and 10 steps, and it is never held at 750.  The drawing
calls write PNG files, the openTSNE and umap branches run on stub modules
(neither is installed here), and without matplotlib the drawing raises
while the embeddings still run.
"""

import functools
import sys

import numpy as np
import pytest

from bblean_tpu import plotting as jplot
from bblean_tpu.analysis import cluster_analysis as j_cluster_analysis
from bblean_tpu.fingerprints import make_fake_fingerprints
from bblean_tpu_torch import plotting as tplot
from bblean_tpu_torch.analysis import cluster_analysis as t_cluster_analysis

from test_tsne import _install_opentsne_stub


@pytest.fixture(scope="module")
def fps():
    return make_fake_fingerprints(120, seed=9)


def _clusters():
    return [list(range(i * 30, (i + 1) * 30)) for i in range(4)]


@pytest.fixture()
def analyses(fps):
    return (
        t_cluster_analysis(_clusters(), fps=fps, top=4),
        j_cluster_analysis(_clusters(), fps=fps, top=4),
    )


def _jax_embedding(monkeypatch, draw, analysis, **kw) -> np.ndarray:
    r"""The embedding a JAX drawing call scatters."""
    seen = []

    def catch(embedding, cluster_sizes, title, output):
        seen.append(np.asarray(embedding))

    monkeypatch.setattr(jplot, "_embed_and_scatter", catch)
    draw(analysis, **kw)
    assert len(seen) == 1
    return seen[0]


def test_pca_embedding_equals_jax(analyses, monkeypatch) -> None:
    got = tplot.pca_embedding(analyses[0])
    ref = _jax_embedding(monkeypatch, jplot.pca_plot, analyses[1])
    assert got.shape == ref.shape == (120, 2)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("n_iter,tol", [(1, 1e-5), (5, 1e-4), (10, 1e-2)])
@pytest.mark.parametrize(
    "kw", [{}, {"perplexity": 10.0, "multiscale": True, "exaggeration": 1.5, "dof": 0.8}]
)
def test_tsne_embedding_equals_jax(analyses, monkeypatch, n_iter, tol, kw) -> None:
    import bblean_tpu.ops.tsne as jtsne

    monkeypatch.setattr(jtsne, "tsne_embed", functools.partial(jtsne.tsne_embed, n_iter=n_iter))
    ref = _jax_embedding(monkeypatch, jplot.tsne_plot, analyses[1], **kw)
    got = tplot.tsne_embedding(analyses[0], n_iter=n_iter, device="cpu", **kw)
    assert got.shape == ref.shape == (120, 2)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * np.abs(ref).max())


def test_tsne_embedding_runs_on_cuda_by_default(analyses) -> None:
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is available")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        tplot.tsne_embedding(analyses[0], n_iter=1)


@pytest.mark.parametrize("multiscale", [False, True])
def test_tsne_opentsne_branch_with_stub(analyses, monkeypatch, tmp_path, multiscale) -> None:
    r"""Where openTSNE imports, both packages take it (with the same
    arguments, so the stub gives both the same points)."""
    _install_opentsne_stub(monkeypatch)
    got = tplot.tsne_embedding(analyses[0], perplexity=10, multiscale=multiscale)
    ref = _jax_embedding(
        monkeypatch, jplot.tsne_plot, analyses[1], perplexity=10, multiscale=multiscale
    )
    np.testing.assert_array_equal(got, ref)
    out = tmp_path / "tsne.png"
    tplot.tsne_plot(analyses[0], output=out, perplexity=10, multiscale=multiscale)
    assert out.stat().st_size > 0


@pytest.mark.parametrize("kind", ["summary", "pops", "pca", "tsne"])
def test_drawing_writes_png(analyses, tmp_path, kind) -> None:
    r"""The population plot gets a cluster of 300 members: past 100 its
    axis is logarithmic (where the JAX module's ``pops_plot`` raises)."""
    out = tmp_path / f"{kind}.png"
    if kind == "summary":
        tplot.summary_plot(analyses[0], output=out)
    elif kind == "pops":
        tplot.pops_plot(analyses[0].sizes + [1, 1, 2, 300], output=out)
    elif kind == "pca":
        tplot.pca_plot(analyses[0], output=out)
    else:
        tplot.tsne_plot(analyses[0], output=out, perplexity=10, n_iter=50, device="cpu")
    assert out.stat().st_size > 0


def test_umap_plot_with_stub(analyses, monkeypatch, tmp_path) -> None:
    import types

    class _StubUMAP:
        def __init__(self, n_components=2, random_state=None):
            self.n = n_components

        def fit_transform(self, x):
            return np.random.default_rng(0).normal(size=(len(x), self.n)).astype(np.float32)

    stub = types.ModuleType("umap")
    stub.UMAP = _StubUMAP
    monkeypatch.setitem(sys.modules, "umap", stub)
    out = tmp_path / "umap.png"
    tplot.umap_plot(analyses[0], output=out)
    assert out.stat().st_size > 0
    monkeypatch.setitem(sys.modules, "umap", None)
    with pytest.raises(ImportError, match="umap-learn is required"):
        tplot.umap_plot(analyses[0])


def test_without_matplotlib_drawing_raises_and_embeddings_run(analyses, monkeypatch) -> None:
    for name in ("matplotlib", "matplotlib.pyplot", "seaborn"):
        monkeypatch.setitem(sys.modules, name, None)
    for draw in (
        lambda: tplot.summary_plot(analyses[0]),
        lambda: tplot.pops_plot(analyses[0].sizes),
        lambda: tplot.pca_plot(analyses[0]),
        lambda: tplot.tsne_plot(analyses[0], device="cpu"),
        lambda: tplot.umap_plot(analyses[0]),
    ):
        with pytest.raises(ImportError, match="matplotlib is required"):
            draw()
    assert tplot.pca_embedding(analyses[0]).shape == (120, 2)
    assert tplot.tsne_embedding(analyses[0], n_iter=2, device="cpu").shape == (120, 2)


def test_plot_adapters_need_input_fps(fps, tmp_path) -> None:
    for kind in ("pca", "tsne", "umap"):
        with pytest.raises(ValueError, match=f"plot-{kind} requires the run dir"):
            getattr(tplot, f"{kind}_plot_from_clusters")(_clusters(), None, 4, tmp_path / "x.png")
