r"""The port's analysis module against the JAX package's, and the port's PCA
against scikit-learn's, on the CPU.

``bblean_tpu_torch/analysis.py`` is a copy of ``bblean_tpu/analysis.py`` on
the port's host modules, so on the same clusters and fingerprints every
field is EQUAL: sizes, labels, size statistics, iSIM (the port's
``similarity.py`` is a copy too), the fingerprints it keeps, the metrics
file's bytes and pandas' ``describe()``.

``bblean_tpu_torch/_pca.py`` copies what the plots use of scikit-learn
1.9.0's ``PCA``: inputs reach each of its three dense solvers (randomized
at 600 x 2048, full at 40 x 256, covariance_eigh at 5000 x 64), and the
embeddings are held to scikit-learn's with ``atol`` = 1e-6 of the
embedding's largest absolute value (float32 rounding of one BLAS; they come
out equal here) and ``rtol`` = 0.
"""

import numpy as np
import pytest

from bblean_tpu import BitBirch
from bblean_tpu import analysis as janalysis
from bblean_tpu.fingerprints import make_fake_fingerprints
from bblean_tpu_torch import analysis as tanalysis

SEED = 12620509540149709235


@pytest.fixture(scope="module")
def clustered():
    fps = make_fake_fingerprints(300, seed=SEED)
    ids = BitBirch(threshold=0.3).fit(fps).get_cluster_mol_ids()
    return fps, ids


def _fields(ca) -> dict:
    r"""Every public number of a ``ClusterAnalysis``."""
    out = {
        name: getattr(ca, name)
        for name in (
            "total_fps", "all_clusters_num", "all_clusters_median_size",
            "all_clusters_q1", "all_clusters_q3", "all_clusters_min_size",
            "all_clusters_max_size", "all_singletons_num", "clusters_num",
            "labels", "sizes", "has_fps", "has_scaffolds", "has_all_clusters",
            "fps_are_packed", "n_features", "min_size",
        )
    }
    out["mean"] = ca.all_clusters_mean_size
    out["above"] = [ca.all_clusters_num_with_size_above(s) for s in (0, 1, 2, 5)]
    if ca.has_fps:
        out["isims"] = ca.isims
    return out


def _sources(kind: str, fps: np.ndarray, tmp_path):
    r"""The ``fps`` argument and the packing of one source kind."""
    if kind == "array":
        return fps, {}
    if kind == "unpacked":
        return np.unpackbits(fps, axis=1), {"input_is_packed": False, "n_features": 2048}
    if kind == "file":
        np.save(tmp_path / "fps.npy", fps)
        return tmp_path / "fps.npy", {}
    if kind == "files":
        paths = []
        for i, (a, b) in enumerate(((0, 120), (120, 121), (121, 300))):
            paths.append(tmp_path / f"fps.{i}.npy")
            np.save(paths[-1], fps[a:b])
        return paths, {}
    return None, {}


@pytest.mark.parametrize("kind", ["array", "unpacked", "file", "files", "none"])
@pytest.mark.parametrize("top,min_size,assume_sorted", [(5, 0, True), (None, 0, True), (20, 3, False)])
def test_cluster_analysis_equals_jax(clustered, tmp_path, kind, top, min_size, assume_sorted) -> None:
    fps, ids = clustered
    if not assume_sorted:
        ids = ids[::-1]
    source, kw = _sources(kind, fps, tmp_path)
    args = dict(fps=source, top=top, min_size=min_size, assume_sorted=assume_sorted, **kw)
    got = tanalysis.cluster_analysis(ids, **args)
    ref = janalysis.cluster_analysis(ids, **args)
    assert _fields(got) == _fields(ref)
    assert got.has_fps == (kind != "none")
    if got.has_fps:
        for packed in (True, False):
            for a, b in zip(got.get_top_cluster_fps(packed), ref.get_top_cluster_fps(packed)):
                np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(got.top_packed_fps, ref.top_packed_fps)
        np.testing.assert_array_equal(got.top_unpacked_fps, ref.top_unpacked_fps)
    else:
        with pytest.raises(RuntimeError, match="Fingerprints not present"):
            got.get_top_cluster_fps()


@pytest.mark.parametrize("with_fps", [True, False])
def test_dump_metrics_and_stats_equal_jax(clustered, tmp_path, with_fps) -> None:
    fps, ids = clustered
    source = fps if with_fps else None
    got = tanalysis.cluster_analysis(ids, fps=source, top=7)
    ref = janalysis.cluster_analysis(ids, fps=source, top=7)
    got.dump_metrics(tmp_path / "port.csv")
    ref.dump_metrics(tmp_path / "jax.csv")
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()
    header = (tmp_path / "port.csv").read_text().splitlines()[0]
    assert header == ("labels,sizes,isim" if with_fps else "labels,sizes")
    assert got.stats.equals(ref.stats)  # pandas is installed here


def test_scaffold_analysis_needs_rdkit(clustered, monkeypatch) -> None:
    r"""Both packages reach RDKit for scaffolds only; without it the same
    error comes from both."""
    import sys

    monkeypatch.setitem(sys.modules, "rdkit", None)
    monkeypatch.setitem(sys.modules, "rdkit.Chem", None)
    monkeypatch.setitem(sys.modules, "rdkit.Chem.Scaffolds", None)
    for mod in (tanalysis, janalysis):
        with pytest.raises(ImportError):
            mod.scaffold_analysis(["CCO"])


# -- the port's copy of scikit-learn's PCA ---------------------------------------


@pytest.mark.parametrize("n_components", [2, 50])
@pytest.mark.parametrize(
    "shape,solver",
    [((600, 2048), "randomized"), ((40, 256), "full"), ((5000, 64), "covariance_eigh")],
)
def test_pca_equals_scikit_learn(shape, solver, n_components) -> None:
    from sklearn.decomposition import PCA as SkPCA

    from bblean_tpu_torch._config import TSNE_SEED
    from bblean_tpu_torch._pca import PCA

    n, f = shape
    x = np.unpackbits(make_fake_fingerprints(n, n_features=f, seed=SEED), axis=1)
    x = x.astype(np.float32)
    sk = SkPCA(n_components=n_components, random_state=TSNE_SEED)
    port = PCA(n_components=n_components, random_state=TSNE_SEED)
    if n_components > min(shape):
        with pytest.raises(ValueError):
            sk.fit_transform(x)
        with pytest.raises(ValueError):
            port.fit_transform(x)
        return
    ref = sk.fit_transform(x)
    got = port.fit_transform(x)
    assert sk._fit_svd_solver == port.fit_svd_solver_ == solver
    assert got.dtype == ref.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * np.abs(ref).max())
    np.testing.assert_allclose(port.components_, sk.components_, rtol=0, atol=1e-6)


def test_pca_float64_and_integer_inputs() -> None:
    r"""float64 stays float64; integers become float64, as scikit-learn's
    input check makes them; the same seed gives the same result twice."""
    from sklearn.decomposition import PCA as SkPCA

    from bblean_tpu_torch._pca import PCA

    bits = np.unpackbits(make_fake_fingerprints(300, n_features=1024, seed=5), axis=1)
    for x in (bits.astype(np.float64), bits):
        ref = SkPCA(n_components=3, random_state=7).fit_transform(x)
        got = PCA(n_components=3, random_state=7).fit_transform(x)
        assert got.dtype == ref.dtype == np.float64
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-9 * np.abs(ref).max())
    a = PCA(n_components=3, random_state=7).fit_transform(bits)
    np.testing.assert_array_equal(a, PCA(n_components=3, random_state=7).fit_transform(bits))
