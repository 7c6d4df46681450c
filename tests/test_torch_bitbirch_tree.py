r"""The port's ``BitBirch`` with both host engines (``ExactTree``,
``NativeExactTree``) and its scikit-learn estimator against the JAX
package's, on the same arrays.

Everything compared is integer-valued (labels, molecule lists, packed
centroids and medoids, CF buffers), so every comparison is exact.  Each case
runs the port's native engine, the port's Python engine and the JAX
package's ``BitBirch`` on the seeds of ``tests/test_tree_api.py``,
``tests/test_native_engine.py`` and ``tests/test_criterion_parity.py``.
"""

import numpy as np
import pytest

import bblean_tpu
import bblean_tpu.tree as j_tree
import bblean_tpu_torch
import bblean_tpu_torch.tree as t_tree
from bblean_tpu.fingerprints import make_fake_fingerprints
from bblean_tpu_torch.engine.native import native_engine_available

SEED = 12620509540149709235
ENGINES = ["python", "native"]

# Golden fixtures for 100 seeded fps, threshold 0.3, diameter merge
# (``tests/test_tree_api.py``)
EXPECT_ASSIGNMENTS = [
    1, 5, 6, 1, 1, 7, 8, 9, 1, 10, 1, 2, 11, 52, 12, 13, 14, 15, 16, 17, 18,
    1, 19, 20, 21, 1, 2, 22, 2, 23, 1, 24, 1, 1, 1, 25, 1, 1, 1, 1, 26, 1,
    27, 28, 29, 1, 2, 30, 31, 2, 32, 33, 34, 2, 2, 35, 36, 37, 38, 2, 2, 39,
    1, 1, 40, 1, 1, 1, 1, 41, 42, 2, 2, 43, 44, 2, 2, 45, 2, 2, 2, 46, 2,
    47, 48, 2, 2, 1, 49, 2, 2, 1, 50, 2, 2, 3, 3, 51, 4, 4,
]


@pytest.fixture
def engine(request, monkeypatch):
    r"""Make both packages' ``BitBirch`` pick one host engine for a test."""
    name = request.param
    if name == "native":
        monkeypatch.delenv("BBLEAN_TPU_NO_EXTENSIONS", raising=False)
        monkeypatch.delenv("BITBIRCH_NO_EXTENSIONS", raising=False)
        if not native_engine_available():
            pytest.skip("no C++ compiler: the native library cannot be built")
    else:
        monkeypatch.setenv("BBLEAN_TPU_NO_EXTENSIONS", "1")
    return name


def _both(**kwargs):
    return bblean_tpu_torch.BitBirch(**kwargs), bblean_tpu.BitBirch(**kwargs)


def _assert_same_tree(got, ref, fps=None) -> None:
    r"""Labels, molecule lists, centroids, buffers and (with ``fps``)
    medoids of two fitted trees are identical."""
    assert got.get_cluster_mol_ids() == ref.get_cluster_mol_ids()
    np.testing.assert_array_equal(got.get_assignments(), ref.get_assignments())
    assert got.num_fitted_fps == ref.num_fitted_fps
    g, r = got.get_centroids_mol_ids(), ref.get_centroids_mol_ids()
    assert g["mol_ids"] == r["mol_ids"]
    np.testing.assert_array_equal(np.stack(g["centroids"]), np.stack(r["centroids"]))
    np.testing.assert_array_equal(
        np.stack(got.get_centroids(packed=False)), np.stack(ref.get_centroids(packed=False))
    )
    gf, gm = got._bf_to_np()
    rf, rm = ref._bf_to_np()
    assert list(gf) == list(rf) and gm == rm
    for key in gf:
        assert len(gf[key]) == len(rf[key])
        for a, b in zip(gf[key], rf[key]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    if fps is not None:
        gmed, rmed = got.get_medoids_mol_ids(fps), ref.get_medoids_mol_ids(fps)
        assert gmed["mol_ids"] == rmed["mol_ids"]
        np.testing.assert_array_equal(gmed["medoids"], rmed["medoids"])
        np.testing.assert_array_equal(got.get_medoids(fps), ref.get_medoids(fps))


@pytest.mark.parametrize("engine", ENGINES, indirect=True)
@pytest.mark.parametrize(
    "criterion,threshold",
    [
        ("diameter", 0.65),
        ("diameter", 0.3),
        ("radius", 0.65),
        ("tolerance-diameter", 0.3),
        ("tolerance-radius", 0.3),
        ("tolerance-legacy", 0.65),
        ("never-merge", 0.3),
    ],
)
def test_fit_equals_jax_package(engine, criterion, threshold) -> None:
    fps = make_fake_fingerprints(400, seed=SEED)
    got, ref = _both(threshold=threshold, merge_criterion=criterion, tolerance=0.05)
    assert got.engine_name == engine
    got.fit(fps)
    ref.fit(fps)
    assert got.engine_name == engine
    assert type(got._engine).__name__ == type(ref._engine).__name__ == (
        "NativeExactTree" if engine == "native" else "ExactTree"
    )
    assert type(got._engine).__module__.startswith("bblean_tpu_torch.")
    _assert_same_tree(got, ref, fps)


@pytest.mark.parametrize("threshold", [0.3, 0.65])
def test_the_two_engines_equal_each_other(monkeypatch, threshold) -> None:
    if not native_engine_available():
        pytest.skip("no C++ compiler: the native library cannot be built")
    fps = make_fake_fingerprints(1000, seed=SEED)
    monkeypatch.delenv("BBLEAN_TPU_NO_EXTENSIONS", raising=False)
    native = bblean_tpu_torch.BitBirch(threshold=threshold).fit(fps)
    monkeypatch.setenv("BBLEAN_TPU_NO_EXTENSIONS", "1")
    python = bblean_tpu_torch.BitBirch(threshold=threshold).fit(fps)
    assert (native.engine_name, python.engine_name) == ("native", "python")
    _assert_same_tree(native, python, fps)
    for tree in (native, python):
        tree.refine_inplace(fps, n_largest=2)
    _assert_same_tree(native, python, fps)


@pytest.mark.parametrize("engine", ENGINES, indirect=True)
def test_golden_assignments_refine_recluster(engine) -> None:
    fps = make_fake_fingerprints(100, n_features=2048, seed=SEED, pack=True)
    got, ref = _both(branching_factor=50, threshold=0.3, merge_criterion="diameter")
    got.fit(fps)
    ref.fit(fps)
    assert got.get_assignments().tolist() == EXPECT_ASSIGNMENTS
    for tree in (got, ref):
        tree.refine_inplace(fps)
    _assert_same_tree(got, ref, fps)
    for tree in (got, ref):
        tree.set_merge("tolerance-diameter", tolerance=0.05, threshold=0.35)
        tree.refine_inplace(fps, n_largest=3)
    _assert_same_tree(got, ref, fps)
    for tree in (got, ref):
        tree.recluster_inplace(iterations=2, extra_threshold=0.02, shuffle=True, seed=5)
    assert got.threshold == ref.threshold
    _assert_same_tree(got, ref, fps)
    for tree in (got, ref):
        tree.recluster_inplace(iterations=3, stop_early=True)
    _assert_same_tree(got, ref, fps)


@pytest.mark.parametrize("engine", ENGINES, indirect=True)
@pytest.mark.parametrize("how", ["array", "unpacked", "list", "file", "odd-width"])
def test_input_kinds_and_reinsert_equal(engine, how, tmp_path) -> None:
    kwargs: dict = {}
    if how == "odd-width":
        fps = make_fake_fingerprints(150, n_features=264, seed=SEED)[:, :33]
        kwargs = dict(n_features=260)
    else:
        fps = make_fake_fingerprints(150, seed=SEED)
    X = fps
    if how == "unpacked":
        X, kwargs = np.unpackbits(fps, axis=-1), dict(input_is_packed=False)
    elif how == "list":
        X = list(fps)
    elif how == "file":
        X = tmp_path / "fps.npy"
        np.save(X, fps)
    got, ref = _both(threshold=0.3)
    for tree in (got, ref):
        tree.fit(X, **kwargs)
        tree.fit(X, max_fps=40, **kwargs)  # a second fit continues the indices
    assert got.num_fitted_fps == 190
    _assert_same_tree(got, ref)
    flat = sorted(i for c in got.get_cluster_mol_ids() for i in c)
    assert flat == list(range(190))
    # A reinsert names its own indices
    got, ref = _both(threshold=0.3)
    for tree in (got, ref):
        tree.fit_reinsert(X, range(149, -1, -1), **kwargs)
    _assert_same_tree(got, ref)
    assert sorted(i for c in got.get_cluster_mol_ids() for i in c) == list(range(150))


@pytest.mark.parametrize("engine", ENGINES, indirect=True)
def test_save_load_and_lifecycle_equal(engine, tmp_path) -> None:
    fps = make_fake_fingerprints(300, seed=SEED)
    more = make_fake_fingerprints(100, seed=4)
    got, ref = _both(threshold=0.3)
    got.fit(fps)
    ref.fit(fps)
    got.save(tmp_path / "t.pkl")
    ref.save(tmp_path / "j.pkl")
    loaded = bblean_tpu_torch.BitBirch.load(tmp_path / "t.pkl")
    loaded_ref = bblean_tpu.BitBirch.load(tmp_path / "j.pkl")
    assert loaded.engine_name == engine
    _assert_same_tree(loaded, got, fps)
    for tree in (got, loaded, loaded_ref):
        tree.fit(more)
    _assert_same_tree(loaded, got)
    _assert_same_tree(loaded, loaded_ref)
    # A pickle names its package: one package's tree is not the other's
    import pickle

    with open(tmp_path / "j.pkl", "rb") as f:
        assert type(pickle.load(f)).__module__ == "bblean_tpu.tree"
    with pytest.raises(ValueError):
        bblean_tpu_torch.BitBirch.load(tmp_path / "j.pkl")

    ids = got.get_cluster_mol_ids()
    got.delete_internal_nodes()
    assert got.get_cluster_mol_ids() == ids
    with pytest.raises(ValueError):
        got.fit(fps)
    got.reset()
    got.fit(fps)
    assert got.num_fitted_fps == 300
    with pytest.raises(ValueError):
        bblean_tpu_torch.BitBirch().get_cluster_mol_ids()
    with pytest.raises(ValueError):
        bblean_tpu_torch.BitBirch().fit(np.zeros((0, 256), np.uint8), n_features=2048)


@pytest.mark.parametrize("engine", ENGINES, indirect=True)
def test_fit_buffers_roundtrip_equal(engine) -> None:
    fps = make_fake_fingerprints(150, seed=SEED)
    source = bblean_tpu.BitBirch(threshold=0.3).fit(fps)
    to_fp, to_mols = source._bf_to_np()
    got, ref = _both(threshold=0.3, merge_criterion="tolerance-diameter")
    for tree in (got, ref):
        for bufs, mols in zip(to_fp.values(), to_mols.values()):
            tree._fit_buffers(bufs, reinsert_index_seqs=mols)
    _assert_same_tree(got, ref, fps)


def test_custom_merge_function_runs_the_python_engine(monkeypatch) -> None:
    from bblean_tpu_torch._merges import DiameterMerge

    monkeypatch.delenv("BBLEAN_TPU_NO_EXTENSIONS", raising=False)

    class Custom(DiameterMerge):
        name = "my-custom"

    fps = make_fake_fingerprints(50, seed=1)
    tree = bblean_tpu_torch.BitBirch(merge_criterion=Custom(), threshold=0.3).fit(fps)
    assert tree.engine_name == "python"
    ref = bblean_tpu.BitBirch(threshold=0.3).fit(fps)
    assert tree.get_cluster_mol_ids() == ref.get_cluster_mol_ids()


def test_defaults_repr_and_repeated_rows() -> None:
    got, ref = _both()
    assert (got.branching_factor, got.threshold, got.merge_criterion) == (50, 0.65, "diameter")
    assert repr(got) == repr(ref)
    got, ref = _both(threshold=0.3, merge_criterion="tolerance-diameter")
    assert repr(got) == repr(ref) and got.tolerance == ref.tolerance == 0.05
    for repeats in (1, 2, 10):
        for value in (0, 1):
            rows = np.packbits(np.full((repeats, 2048), value, np.uint8), axis=-1)
            assert bblean_tpu_torch.BitBirch().fit(rows).get_cluster_mol_ids() == [
                list(range(repeats))
            ]


def test_global_set_merge_is_per_package() -> None:
    r"""Each package's ``set_merge`` mutates its own module: a test of both
    sets both."""
    with pytest.warns(UserWarning):
        t_tree.set_merge("radius")
    try:
        assert bblean_tpu_torch.BitBirch().merge_criterion == "radius"
        assert bblean_tpu.BitBirch().merge_criterion == "diameter"
        with pytest.raises(ValueError):
            bblean_tpu_torch.BitBirch(merge_criterion="diameter")
        with pytest.raises(ValueError):
            bblean_tpu_torch.BitBirch().set_merge("diameter")
        with pytest.warns(UserWarning):
            j_tree.set_merge("radius")
        fps = make_fake_fingerprints(120, seed=SEED)
        got, ref = _both(threshold=0.5)
        _assert_same_tree(got.fit(fps), ref.fit(fps))
    finally:
        t_tree._global_merge_accept = None
        j_tree._global_merge_accept = None
    assert bblean_tpu_torch.BitBirch().merge_criterion == "diameter"


def test_dump_assignments_equal(tmp_path) -> None:
    fps = make_fake_fingerprints(50, seed=SEED)
    smiles = [f"C{i}" for i in range(50)]
    got, ref = _both(threshold=0.3)
    got.fit(fps).dump_assignments(tmp_path / "t.csv", smiles=smiles)
    ref.fit(fps).dump_assignments(tmp_path / "j.csv", smiles=smiles)
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()


# -- global clustering ------------------------------------------------------------


@pytest.mark.parametrize(
    "method,kwargs",
    [
        ("kmeans", dict(n_init=2, random_state=0)),
        ("kmeans-normalized", dict(n_init=1, random_state=3)),
        ("agglomerative", dict(linkage="average")),
    ],
)
def test_global_clustering_with_scikit_learn_equals(method, kwargs) -> None:
    fps = make_fake_fingerprints(200, seed=SEED)
    got, ref = _both(threshold=0.3)
    for tree in (got, ref):
        tree.fit(fps)
        with pytest.warns(UserWarning):
            tree.global_clustering(5, method=method, **kwargs)
    np.testing.assert_array_equal(
        got.get_assignments(global_clusters=True), ref.get_assignments(global_clusters=True)
    )
    assert got.get_cluster_mol_ids(global_clusters=True) == ref.get_cluster_mol_ids(
        global_clusters=True
    )
    assert len(got.get_cluster_mol_ids(global_clusters=True)) == 5
    with pytest.raises(ValueError), pytest.warns(UserWarning):
        got.global_clustering(3, method="no-such-method")


def test_global_clustering_kmeans_tpu_on_the_cpu() -> None:
    r"""The port's k-means seeds with torch's generator, so its labels are
    its own: deterministic for a seed, in ``1..k``, covering every molecule."""
    fps = make_fake_fingerprints(300, seed=SEED)
    tree = bblean_tpu_torch.BitBirch(threshold=0.3).fit(fps)
    runs = []
    for seed in (0, 0, 1):
        with pytest.warns(UserWarning):
            tree.global_clustering(4, method="kmeans-tpu", seed=seed, device="cpu")
        labels = tree.get_assignments(global_clusters=True)
        assert labels.shape == (300,) and set(np.unique(labels)) <= {1, 2, 3, 4}
        mol_ids = tree.get_cluster_mol_ids(global_clusters=True)
        assert len(mol_ids) == 4
        assert sorted(i for c in mol_ids for i in c) == list(range(300))
        runs.append(labels)
    np.testing.assert_array_equal(runs[0], runs[1])
    # More clusters than centroids: k falls to their number, with a warning
    small = bblean_tpu_torch.BitBirch(threshold=0.1).fit(fps[:30])
    k = len(small.get_cluster_mol_ids())
    with pytest.warns(Warning, match="less than"):
        small.global_clustering(k + 5, method="kmeans-tpu", device="cpu")
    assert len(small.get_cluster_mol_ids(global_clusters=True)) <= k


def test_global_clustering_kmeans_tpu_needs_the_card_or_an_explicit_cpu() -> None:
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is available")
    fps = make_fake_fingerprints(100, seed=SEED)
    tree = bblean_tpu_torch.BitBirch(threshold=0.3).fit(fps)
    with pytest.raises(RuntimeError, match="needs a CUDA device"), pytest.warns(UserWarning):
        tree.global_clustering(3, method="kmeans-tpu")


# -- the scikit-learn estimator -------------------------------------------------------


@pytest.mark.parametrize("engine", ENGINES, indirect=True)
def test_sklearn_estimator_equals(engine) -> None:
    from bblean_tpu import sklearn as j_sk
    from bblean_tpu_torch import sklearn as t_sk

    fps = make_fake_fingerprints(200, seed=SEED)
    queries = make_fake_fingerprints(40, seed=9)
    got, ref = t_sk.BitBirch(threshold=0.3), j_sk.BitBirch(threshold=0.3)
    np.testing.assert_array_equal(got.fit_predict(fps), ref.fit_predict(fps))
    np.testing.assert_array_equal(got.labels_, ref.labels_)
    np.testing.assert_array_equal(got.subcluster_centers_, ref.subcluster_centers_)
    np.testing.assert_array_equal(got.subcluster_labels_, ref.subcluster_labels_)
    np.testing.assert_array_equal(got.predict(queries), ref.predict(queries))
    np.testing.assert_array_equal(got.transform(queries), ref.transform(queries))
    assert got.get_params() == ref.get_params()
    got.set_params(threshold=0.5)
    assert got.threshold == 0.5

    unpacked = np.unpackbits(fps, axis=-1)
    got_u = t_sk.UnpackedBitBirch(threshold=0.3).fit(unpacked)
    ref_u = j_sk.UnpackedBitBirch(threshold=0.3).fit(unpacked)
    np.testing.assert_array_equal(got_u.labels_, ref_u.labels_)
    np.testing.assert_array_equal(got_u.labels_, ref.labels_)
    np.testing.assert_array_equal(got_u.predict(unpacked[:20]), ref_u.predict(unpacked[:20]))

    got_p, ref_p = t_sk.BitBirch(threshold=0.3), j_sk.BitBirch(threshold=0.3)
    for est in (got_p, ref_p):
        est.partial_fit(fps[:100])
        est.partial_fit(fps[100:])
    assert got_p.num_fitted_fps == 200
    np.testing.assert_array_equal(got_p.labels_, ref_p.labels_)


# -- the criterion's knees (seeds of tests/test_criterion_parity.py) ------------------


@pytest.mark.parametrize("old_n", [1, 2, 999, 1000, 1001, 10_000])
@pytest.mark.parametrize("threshold", [0.3, 0.65])
def test_adaptive_tolerance_knees_decide_alike(threshold, old_n) -> None:
    r"""Constructed clusters of ``n`` members with every feature at count
    ``x`` have the exact iSIM ``(x - 1) / (2n - x - 1)``; sweeping ``x``
    around the threshold samples the decision's neighbourhood."""
    from bblean_tpu._merges import get_merge_accept_fn as j_get
    from bblean_tpu_torch._merges import get_merge_accept_fn as t_get

    F = 2048
    new_n = old_n + 1
    x0 = max(2, round((threshold * (2 * new_n - 1) + 1) / (1 + threshold)))
    checked = 0
    for criterion in ("tolerance-diameter", "tolerance-radius", "tolerance-legacy", "diameter"):
        got_fn, ref_fn = t_get(criterion, 0.05), j_get(criterion, 0.05)
        for x in range(max(2, x0 - 6), min(new_n, x0 + 7)):
            new_ls = np.full(F, x, dtype=np.int64)
            old_ls = np.full(F, max(x - 1, 0), dtype=np.int64)
            nom_ls = new_ls - old_ls
            args = (threshold, new_ls, new_n, old_ls, nom_ls, old_n, 1)
            assert bool(got_fn(*args)) == bool(ref_fn(*args)), (criterion, x)
            checked += 1
    assert checked > 0 or new_n <= 2
