r"""Plotting of clustering results.

The port of ``bblean_tpu/plotting.py``, with its functions and names:
population KDE (``pops_plot``), summary bars with an iSIM twin axis
(``summary_plot``), PCA / t-SNE / UMAP embeddings of the top clusters
(``pca_plot``, ``tsne_plot``, ``umap_plot``), an RDKit grid of molecules
(``dump_mol_images``) and the command line's ``*_plot_from_clusters``
adapters.  Three things differ:

- matplotlib (Agg backend, PNG files) and seaborn are imported by the
  drawing code, not with the module; a drawing call without them raises
  ``ImportError`` naming the package.
- Each embedding is a function of its own, apart from its drawing:
  ``pca_embedding`` (the port's copy of scikit-learn's PCA, ``_pca.py``) and
  ``tsne_embedding`` (the same PCA reduction, perplexity clamp and
  openTSNE-first order as the JAX ``tsne_plot``; without openTSNE the port's
  ``ops/tsne.py::tsne_embed`` on ``device``, default ``"cuda"``).  So the
  embeddings run where matplotlib is not installed.
- ``tsne_plot`` takes ``n_iter`` and ``device`` for ``tsne_embed``.

``pops_plot`` passes seaborn a Python bool for its log scale: the JAX
module passes numpy's ``True`` once a cluster has more than 100 members,
which seaborn reads as the log base 1, and raises.
"""

from __future__ import annotations

import typing as tp
from pathlib import Path

import numpy as np
from numpy.typing import NDArray

from bblean_tpu_torch._config import TSNE_SEED
from bblean_tpu_torch._device import DeviceLike
from bblean_tpu_torch.analysis import ClusterAnalysis, cluster_analysis

__all__ = [
    "pops_plot",
    "summary_plot",
    "pca_plot",
    "tsne_plot",
    "umap_plot",
    "pca_embedding",
    "tsne_embedding",
]


def _pyplot() -> tp.Any:
    r"""``matplotlib.pyplot`` on the Agg backend."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(
            "matplotlib is required for plots but is not installed"
        ) from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def pops_plot(
    cluster_sizes: tp.Sequence[int],
    output: Path | str | None = None,
    ax: tp.Any = None,
) -> tp.Any:
    r"""KDE of the cluster-size (population) distribution."""
    plt = _pyplot()
    try:
        import seaborn as sns
    except ImportError as e:
        raise ImportError(
            "seaborn is required for population plots but is not installed"
        ) from e

    if ax is None:
        _fig, ax = plt.subplots(figsize=(8, 5))
    sizes = np.asarray(cluster_sizes)
    # A Python bool: seaborn reads numpy's True as the log base 1 and raises
    sns.kdeplot(sizes, ax=ax, fill=True, log_scale=bool(sizes.max() > 100))
    ax.set_xlabel("Cluster size")
    ax.set_ylabel("Density")
    ax.set_title("Cluster population distribution")
    if output is not None:
        ax.figure.savefig(output, dpi=150, bbox_inches="tight")
        plt.close(ax.figure)
    return ax


def summary_plot(
    analysis: ClusterAnalysis,
    output: Path | str | None = None,
) -> tp.Any:
    r"""Bar plot of top-cluster sizes with an iSIM twin axis (and scaffold
    counts when available)."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(10, 5))
    labels = [str(x) for x in analysis.labels]
    ax.bar(labels, analysis.sizes, color="#4878CF", label="size")
    ax.set_xlabel("Cluster")
    ax.set_ylabel("Size")
    if analysis.has_scaffolds:
        ax.bar(
            labels,
            analysis.unique_scaffolds_num,
            color="#EE854A",
            alpha=0.7,
            label="unique scaffolds",
        )
    if analysis.has_fps:
        ax2 = ax.twinx()
        ax2.plot(labels, analysis.isims, "o-", color="#D65F5F", label="iSIM")
        ax2.set_ylabel("iSIM")
        ax2.set_ylim(0, 1)
    ax.legend(loc="upper right")
    ax.set_title(
        f"Top {analysis.clusters_num} of {analysis.all_clusters_num} clusters"
        f" ({analysis.total_fps:,} fingerprints)"
    )
    if output is not None:
        fig.savefig(output, dpi=150, bbox_inches="tight")
        plt.close(fig)
    return ax


def _scatter(
    plt: tp.Any,
    embedding: NDArray[np.floating],
    cluster_sizes: tp.Sequence[int],
    title: str,
    output: Path | str | None,
) -> tp.Any:
    fig, ax = plt.subplots(figsize=(7, 6))
    labels = np.repeat(np.arange(len(cluster_sizes)), cluster_sizes)
    scatter = ax.scatter(
        embedding[:, 0], embedding[:, 1], c=labels, cmap="tab20", s=8, alpha=0.8
    )
    fig.colorbar(scatter, ax=ax, label="cluster")
    ax.set_title(title)
    if output is not None:
        fig.savefig(output, dpi=150, bbox_inches="tight")
        plt.close(fig)
    return ax


def pca_embedding(analysis: ClusterAnalysis) -> NDArray[np.floating]:
    r"""2-D PCA of the top clusters' fingerprints (float32, on the host)."""
    from bblean_tpu_torch._pca import PCA

    fps = analysis.top_unpacked_fps.astype(np.float32)
    return PCA(n_components=2, random_state=TSNE_SEED).fit_transform(fps)


def pca_plot(
    analysis: ClusterAnalysis, output: Path | str | None = None
) -> tp.Any:
    r"""2-D PCA embedding of the top clusters' fingerprints."""
    plt = _pyplot()
    return _scatter(
        plt, pca_embedding(analysis), analysis.sizes, "PCA of top clusters", output
    )


def tsne_embedding(
    analysis: ClusterAnalysis,
    perplexity: float = 30.0,
    pca_reduce: int | None = 50,
    exaggeration: float | None = None,
    do_pca_init: bool = True,
    multiscale: bool = False,
    dof: float = 1.0,
    n_iter: int = 750,
    device: DeviceLike = "cuda",
) -> NDArray[np.floating]:
    r"""2-D t-SNE embedding of the top clusters' fingerprints.

    The rows are first reduced to ``pca_reduce`` components by PCA (on the
    host) and the perplexity is clamped to the row count.  openTSNE is used
    where it is installed (the reference's FFT path; ``n_iter`` and
    ``device`` do not apply to it); otherwise ``ops/tsne.py::tsne_embed``
    runs ``n_iter`` exact-gradient steps on ``device``, with the same
    surface: PCA init, multiscale affinities, second-phase exaggeration and
    the ``dof`` knob.
    """
    fps = analysis.top_unpacked_fps.astype(np.float32)
    if pca_reduce is not None and fps.shape[1] > pca_reduce:
        from bblean_tpu_torch._pca import PCA

        fps = PCA(
            n_components=min(pca_reduce, len(fps) - 1), random_state=TSNE_SEED
        ).fit_transform(fps)
    perplexity = min(perplexity, max((len(fps) - 1) / 3, 2))
    try:
        from openTSNE import TSNE as OpenTSNE
        from openTSNE.affinity import Multiscale

        tsne = OpenTSNE(
            n_components=2,
            perplexity=perplexity,
            random_state=TSNE_SEED,
            dof=dof,
            exaggeration=exaggeration,
            negative_gradient_method="fft",
            initialization="pca" if do_pca_init else "random",
        )
        if multiscale:
            return np.asarray(
                super(OpenTSNE, tsne).fit(
                    fps,
                    affinities=Multiscale(
                        data=fps,
                        perplexities=[perplexity, len(fps) / 100],
                        random_state=TSNE_SEED,
                    ),
                    initialization="pca" if do_pca_init else "random",
                )
            )
        return np.asarray(tsne.fit(fps))
    except ImportError:
        from bblean_tpu_torch.ops.tsne import tsne_embed

        return tsne_embed(
            fps,
            perplexity=perplexity,
            n_iter=n_iter,
            exaggeration=exaggeration,
            seed=TSNE_SEED,
            do_pca_init=do_pca_init,
            multiscale=multiscale,
            dof=dof,
            device=device,
        )


def tsne_plot(
    analysis: ClusterAnalysis,
    output: Path | str | None = None,
    perplexity: float = 30.0,
    pca_reduce: int | None = 50,
    exaggeration: float | None = None,
    do_pca_init: bool = True,
    multiscale: bool = False,
    dof: float = 1.0,
    n_iter: int = 750,
    device: DeviceLike = "cuda",
) -> tp.Any:
    r"""2-D t-SNE embedding of the top clusters' fingerprints
    (``tsne_embedding``), drawn."""
    plt = _pyplot()
    emb = tsne_embedding(
        analysis, perplexity=perplexity, pca_reduce=pca_reduce,
        exaggeration=exaggeration, do_pca_init=do_pca_init,
        multiscale=multiscale, dof=dof, n_iter=n_iter, device=device,
    )
    return _scatter(plt, emb, analysis.sizes, "t-SNE of top clusters", output)


def umap_plot(
    analysis: ClusterAnalysis, output: Path | str | None = None
) -> tp.Any:
    r"""2-D UMAP embedding of the top clusters (requires umap-learn)."""
    plt = _pyplot()
    try:
        import umap
    except ImportError as e:
        raise ImportError(
            "umap-learn is required for UMAP plots but is not installed"
        ) from e
    fps = analysis.top_unpacked_fps.astype(np.float32)
    emb = umap.UMAP(n_components=2, random_state=TSNE_SEED).fit_transform(fps)
    return _scatter(plt, emb, analysis.sizes, "UMAP of top clusters", output)


def dump_mol_images(
    smiles: tp.Sequence[str],
    out_dir: Path | str,
    mols_per_row: int = 5,
    max_mols: int = 30,
) -> None:
    r"""Write an RDKit grid image of molecules (requires RDKit)."""
    from rdkit.Chem import Draw, MolFromSmiles  # Requires RDKit

    mols = [MolFromSmiles(s) for s in smiles[:max_mols]]
    img = Draw.MolsToGridImage(mols, molsPerRow=mols_per_row)
    out = Path(out_dir) / "mols.png"
    with open(out, "wb") as f:
        f.write(img.data if hasattr(img, "data") else img)


# -- CLI adapters: build the analysis from clusters + fps files ----------------


def _analysis_from_clusters(
    clusters: list[list[int]], fps: tp.Any, top: int
) -> ClusterAnalysis:
    return cluster_analysis(clusters, fps=fps, top=top)


def summary_plot_from_clusters(
    clusters: list[list[int]], fps: tp.Any, top: int, output: Path
) -> None:
    summary_plot(_analysis_from_clusters(clusters, fps, top), output=output)


def pops_plot_from_clusters(
    clusters: list[list[int]], fps: tp.Any, top: int, output: Path
) -> None:
    pops_plot([len(c) for c in clusters], output=output)


def pca_plot_from_clusters(
    clusters: list[list[int]], fps: tp.Any, top: int, output: Path
) -> None:
    _require_fps(fps, "plot-pca")
    pca_plot(_analysis_from_clusters(clusters, fps, top), output=output)


def tsne_plot_from_clusters(
    clusters: list[list[int]],
    fps: tp.Any,
    top: int,
    output: Path,
    device: DeviceLike = "cuda",
) -> None:
    _require_fps(fps, "plot-tsne")
    tsne_plot(
        _analysis_from_clusters(clusters, fps, top), output=output, device=device
    )


def umap_plot_from_clusters(
    clusters: list[list[int]], fps: tp.Any, top: int, output: Path
) -> None:
    _require_fps(fps, "plot-umap")
    umap_plot(_analysis_from_clusters(clusters, fps, top), output=output)


def _require_fps(fps: tp.Any, command: str) -> None:
    if fps is None:
        raise ValueError(
            f"{command} requires the run dir to contain input-fps/ files"
        )
