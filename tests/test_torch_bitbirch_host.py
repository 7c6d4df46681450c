r"""The port's host modules under ``BitBirch`` against the JAX package's, on
the same arrays: ``_np_similarity``, ``similarity`` (NumPy and native
backends), ``_merges``, ``metrics``, and the native library's build.

Tolerances.  The NumPy backend is the same code as ``bblean_tpu``'s, so its
values are held exactly equal.  The native backend's Tanimoto functions are
integer popcounts and one division: exactly equal too.  The native iSIM takes
the same exact uint64 sums and converts them to float64 at other points of
the quotient than NumPy does, so it may part in the last bits: it is held to
1e-12 relative.
"""

import os
import stat
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from bblean_tpu import _merges as j_merges
from bblean_tpu import _np_similarity as j_np
from bblean_tpu import metrics as j_metrics
from bblean_tpu import similarity as j_sim
from bblean_tpu.fingerprints import make_fake_fingerprints
from bblean_tpu_torch import _build, _native
from bblean_tpu_torch import _merges as t_merges
from bblean_tpu_torch import _np_similarity as t_np
from bblean_tpu_torch import metrics as t_metrics
from bblean_tpu_torch import similarity as t_sim
from bblean_tpu_torch.engine.native import native_engine_available

ROOT = Path(__file__).resolve().parent.parent
SEED = 12620509540149709235
BACKENDS = ["numpy", "native"]


@pytest.fixture
def backend(request, monkeypatch):
    r"""Point the port's similarity facade at one backend for a test."""
    name = request.param
    if name == "native":
        monkeypatch.delenv("BBLEAN_TPU_NO_EXTENSIONS", raising=False)
        monkeypatch.delenv("BITBIRCH_NO_EXTENSIONS", raising=False)
        if not native_engine_available():
            pytest.skip("no C++ compiler: the native library cannot be built")
    else:
        monkeypatch.setenv("BBLEAN_TPU_NO_EXTENSIONS", "1")
    monkeypatch.setattr(t_sim, "_backend", None)  # choose again, undone after
    assert t_sim.backend_name() == name
    return name


def _same(a, b, exact: bool = True) -> None:
    if exact:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    else:
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-12, atol=0)


# -- _np_similarity: the same code, the same values ---------------------------


@pytest.mark.parametrize("n_features", [2048, 264, 8])
def test_np_similarity_functions_equal(n_features) -> None:
    bits = make_fake_fingerprints(60, n_features=n_features, seed=SEED, pack=False)
    packed = np.packbits(bits, axis=-1)
    _same(t_np.popcount(packed), j_np.popcount(packed))
    ls = bits.sum(0, dtype=np.uint64)
    for pack in (True, False):
        _same(t_np.centroid_from_sum(ls, 60, pack=pack), j_np.centroid_from_sum(ls, 60, pack=pack))
    _same(t_np.centroid(packed, True, n_features), j_np.centroid(packed, True, n_features))
    _same(t_np.centroid(bits, False), j_np.centroid(bits, False))
    for n in (2, 7, 60):
        sub = bits[:n].sum(0, dtype=np.uint64)
        assert t_np.jt_isim_from_sum(sub, n) == j_np.jt_isim_from_sum(sub, n)
    assert t_np.jt_isim_unpacked(bits) == j_np.jt_isim_unpacked(bits)
    assert t_np.jt_isim_packed(packed, n_features) == j_np.jt_isim_packed(packed, n_features)
    _same(t_np._jt_sim_arr_vec_packed(packed, packed[3]), j_np._jt_sim_arr_vec_packed(packed, packed[3]))
    for got, ref in zip(
        t_np.jt_most_dissimilar_packed(packed, n_features),
        j_np.jt_most_dissimilar_packed(packed, n_features),
    ):
        _same(got, ref)
    _same(t_np.jt_compl_isim(packed, True, n_features), j_np.jt_compl_isim(packed, True, n_features))
    _same(t_np.jt_compl_isim(bits, False), j_np.jt_compl_isim(bits, False))
    _same(t_np.jt_isim_medoid(packed, True, n_features)[1], j_np.jt_isim_medoid(packed, True, n_features)[1])
    assert t_np.jt_isim_medoid(bits, False)[0] == j_np.jt_isim_medoid(bits, False)[0]


def test_np_isim_edge_cases_equal() -> None:
    one = make_fake_fingerprints(1, seed=SEED, pack=False)
    with pytest.warns(RuntimeWarning):
        assert np.isnan(t_np.jt_isim_from_sum(one.sum(0), 1))
    zeros = np.zeros(2048, dtype=np.uint64)
    assert t_np.jt_isim_from_sum(zeros, 5) == j_np.jt_isim_from_sum(zeros, 5) == 1


# -- similarity: both backends against the JAX package's NumPy functions -------


@pytest.mark.parametrize("backend", BACKENDS, indirect=True)
def test_similarity_tanimoto_functions_equal_exactly(backend) -> None:
    fps = make_fake_fingerprints(40, seed=SEED)
    _same(t_sim.jt_sim_packed(fps, fps[0]), j_np._jt_sim_arr_vec_packed(fps, fps[0]))
    _same(t_sim.jt_sim_packed(fps[1], fps), j_np._jt_sim_arr_vec_packed(fps, fps[1]))
    assert t_sim.jt_sim_packed(fps[1], fps[2]) == j_np._jt_sim_arr_vec_packed(fps[1:2], fps[2])[0]
    with pytest.raises(ValueError):
        t_sim.jt_sim_packed(fps, fps)
    zero = np.zeros_like(fps[:3])
    _same(t_sim.jt_sim_packed(zero, zero[0]), j_sim.jt_sim_packed(zero, zero[0]))
    for got, ref in zip(t_sim.jt_most_dissimilar_packed(fps), j_np.jt_most_dissimilar_packed(fps)):
        _same(got, ref)
    _same(t_sim.jt_sim_matrix_packed(fps[:12]), j_sim.jt_sim_matrix_packed(fps[:12]))
    _same(t_sim.jt_stratified_sampling(fps, 7), j_sim.jt_stratified_sampling(fps, 7))
    assert t_sim.estimate_jt_std(fps, 10) == j_sim.estimate_jt_std(fps, 10)


@pytest.mark.parametrize("backend", BACKENDS, indirect=True)
def test_similarity_isim_functions_equal(backend) -> None:
    r"""Exactly on the NumPy backend; to 1e-12 on the native one."""
    exact = backend == "numpy"
    bits = make_fake_fingerprints(100, seed=SEED, pack=False)
    packed = np.packbits(bits, axis=-1)
    for n in (2, 3, 50, 100):
        ls = bits[:n].sum(0, dtype=np.uint64)
        _same(t_sim.jt_isim_from_sum(ls, n), j_np.jt_isim_from_sum(ls, n), exact)
        _same(t_sim.jt_isim_diameter_from_sum(ls, n), 1 - j_np.jt_isim_from_sum(ls, n), exact)
        ref = j_sim.jt_isim_radius_compl_from_sum(ls, n)
        _same(t_sim.jt_isim_radius_compl_from_sum(ls, n), ref, exact)
        _same(t_sim.jt_isim_radius_from_sum(ls, n), 1 - ref, exact)
    _same(t_sim.jt_isim(packed), j_np.jt_isim_packed(packed), exact)
    _same(t_sim.jt_isim(bits, input_is_packed=False), j_np.jt_isim_unpacked(bits), exact)
    _same(t_sim.jt_isim_diameter(packed), 1 - j_np.jt_isim_packed(packed), exact)
    _same(t_sim.jt_isim_radius(packed), j_sim.jt_isim_radius(packed), exact)
    _same(t_sim.jt_isim_radius_compl(bits, False), j_sim.jt_isim_radius_compl(bits, False), exact)
    with pytest.warns(RuntimeWarning):
        assert np.isnan(t_sim.jt_isim_from_sum(bits[0].astype(np.uint64), 1))
    assert t_sim.jt_isim_from_sum(np.zeros(2048, np.uint64), 4) == 1


def test_similarity_reexports_the_numpy_helpers() -> None:
    for name in ("centroid", "centroid_from_sum", "jt_isim_medoid", "jt_compl_isim"):
        assert getattr(t_sim, name) is getattr(t_np, name)
    assert sorted(t_sim.__all__) == sorted(j_sim.__all__)


# -- merge criteria: every built-in criterion decides alike ---------------------


def _merge_cases():
    fps = make_fake_fingerprints(40, n_features=256, seed=7, pack=False).astype(np.int64)
    cases = []
    for old_count in (1, 2, 9):
        for nom_count in (1, 2, 5):
            old = fps[:old_count]
            nom = fps[old_count : old_count + nom_count]
            cases.append((old.sum(0), old_count, nom.sum(0), nom_count))
    return cases


@pytest.mark.parametrize("backend", BACKENDS, indirect=True)
@pytest.mark.parametrize("criterion", sorted(j_merges.BUILTIN_MERGES))
def test_builtin_merge_criteria_decide_alike(criterion, backend) -> None:
    assert sorted(t_merges.BUILTIN_MERGES) == sorted(j_merges.BUILTIN_MERGES)
    decisions = 0
    for tolerance in (0.0, 0.05, 0.2):
        got_fn = t_merges.get_merge_accept_fn(criterion, tolerance)
        ref_fn = j_merges.get_merge_accept_fn(criterion, tolerance)
        assert got_fn.name == ref_fn.name == criterion
        assert repr(got_fn) == repr(ref_fn)
        for threshold in (0.0, 0.2, 0.5, 0.65, 1.0):
            for old_ls, old_n, nom_ls, nom_n in _merge_cases():
                args = (threshold, old_ls + nom_ls, old_n + nom_n, old_ls, nom_ls, old_n, nom_n)
                assert bool(got_fn(*args)) == bool(ref_fn(*args)), (tolerance, threshold, old_n, nom_n)
                decisions += 1
    assert decisions == 135


def test_merge_factory_rejects_unknown_names() -> None:
    with pytest.raises(ValueError):
        t_merges.get_merge_accept_fn("no-such-criterion")


# -- metrics ------------------------------------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS, indirect=True)
def test_cluster_metrics_equal(backend) -> None:
    import bblean_tpu

    exact = backend == "numpy"
    fps = make_fake_fingerprints(300, seed=SEED)
    ids = bblean_tpu.BitBirch(threshold=0.3).fit(fps).get_cluster_mol_ids()
    clusters = [fps[c] for c in ids if len(c) >= 2][:10]
    unpacked = [np.unpackbits(c, axis=-1) for c in clusters]
    # The JAX package's facade chose its backend when it was imported; the
    # native one parts from NumPy in iSIM's last bits, hence the tolerance
    both_numpy = exact and not j_sim._native_loaded
    _same(t_metrics.jt_isim_chi(clusters), j_metrics.jt_isim_chi(clusters), both_numpy)
    _same(
        t_metrics.jt_isim_chi(unpacked, input_is_packed=False),
        j_metrics.jt_isim_chi(unpacked, input_is_packed=False), both_numpy,
    )
    assert t_metrics.jt_isim_chi(clusters[:1]) == 0
    for centrals in ("centroid", "medoid"):
        _same(
            t_metrics.jt_dbi(clusters, centrals=centrals),
            j_metrics.jt_dbi(clusters, centrals=centrals), both_numpy,
        )
    _same(t_metrics.jt_isim_dunn(clusters), j_metrics.jt_isim_dunn(clusters), both_numpy)


# -- the native library: built by the port, for the port ----------------------------


def test_native_library_is_the_ports_own_build(monkeypatch) -> None:
    r"""The library the port loads lies under its own ``csrc/build/``, named
    by the hash of its source and flags; never the JAX package's."""
    monkeypatch.delenv("BBLEAN_TPU_NO_EXTENSIONS", raising=False)
    if not native_engine_available():
        pytest.skip("no C++ compiler: the native library cannot be built")
    path = _native.loaded_lib_path()
    assert path is not None and path == _native.native_lib_path()
    assert path.parent == ROOT / "bblean_tpu_torch" / "csrc" / "build"
    assert path.name.startswith("bblean_native_") and path.suffix == ".so"
    assert "bblean_tpu/csrc" not in path.as_posix()
    # A concurrent build may have renamed its own file over the one this
    # process mapped, which then reads "<path> (deleted)"
    with open("/proc/self/maps") as f:
        mapped = {line.split(None, 5)[-1].strip().removesuffix(" (deleted)") for line in f}
    assert os.fspath(path) in mapped
    from bblean_tpu_torch.utils import (
        native_extensions_are_enabled,
        native_extensions_are_installed,
    )

    assert native_extensions_are_installed() and native_extensions_are_enabled()
    monkeypatch.setenv("BBLEAN_TPU_NO_EXTENSIONS", "1")
    assert native_extensions_are_installed() and not native_extensions_are_enabled()
    monkeypatch.setenv("BBLEAN_TPU_NO_EXTENSIONS", "0")  # "0" means enabled
    assert native_extensions_are_enabled()


def test_native_source_is_a_byte_copy() -> None:
    src = ROOT / "bblean_tpu_torch" / "csrc" / "bblean_native.cpp"
    assert src.read_bytes() == (ROOT / "bblean_tpu" / "csrc" / "bblean_native.cpp").read_bytes()


def _fresh_native(monkeypatch, tmp_path, cxx: str) -> None:
    r"""A process state in which nothing is built or loaded yet, with ``cxx``
    as the compiler and an empty build directory."""
    monkeypatch.delenv("BBLEAN_TPU_NO_EXTENSIONS", raising=False)
    monkeypatch.delenv("BITBIRCH_NO_EXTENSIONS", raising=False)
    monkeypatch.setenv("CXX", cxx)
    monkeypatch.setattr(_build, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_native, "_lib", None)
    monkeypatch.setattr(_native, "_lib_path", None)
    monkeypatch.setattr(_native, "_failure", None)
    monkeypatch.setattr(t_sim, "_backend", None)


def test_a_compiler_that_fails_raises_with_its_output(monkeypatch, tmp_path) -> None:
    from bblean_tpu_torch import BitBirch

    cxx = tmp_path / "broken-cxx"
    cxx.write_text("#!/bin/sh\necho 'bblean_native.cpp:1:1: error: made to fail' >&2\nexit 3\n")
    cxx.chmod(cxx.stat().st_mode | stat.S_IXUSR)
    _fresh_native(monkeypatch, tmp_path, os.fspath(cxx))
    fps = make_fake_fingerprints(30, seed=1)
    for _ in range(2):  # the failure is remembered, not retried into a give-way
        with pytest.raises(RuntimeError, match="made to fail") as err:
            BitBirch(threshold=0.3).fit(fps)
        assert "exit 3" in str(err.value)
    with pytest.raises(RuntimeError, match="made to fail"):
        native_engine_available()
    with pytest.raises(RuntimeError, match="made to fail"):
        t_sim.jt_isim(fps)
    assert not list((tmp_path / "build").glob("*.so"))
    # The switch selects the Python engine without asking the compiler
    monkeypatch.setenv("BBLEAN_TPU_NO_EXTENSIONS", "1")
    tree = BitBirch(threshold=0.3).fit(fps)
    assert tree.engine_name == "python"


def test_no_compiler_selects_the_python_engine(monkeypatch, tmp_path) -> None:
    import bblean_tpu
    from bblean_tpu_torch import BitBirch
    from bblean_tpu_torch.utils import native_extensions_are_installed

    _fresh_native(monkeypatch, tmp_path, "no-such-compiler-on-this-machine")
    monkeypatch.setenv("PATH", os.fspath(tmp_path))  # no g++ and no c++ either
    assert not native_engine_available()
    assert not native_extensions_are_installed()
    assert _native.native_lib_path() is None and _native.loaded_lib_path() is None
    fps = make_fake_fingerprints(200, seed=SEED)
    tree = BitBirch(threshold=0.3)
    assert tree.engine_name == "python"
    tree.fit(fps)
    assert tree.engine_name == "python" and type(tree._engine).__name__ == "ExactTree"
    assert t_sim.backend_name() == "numpy"
    ref = bblean_tpu.BitBirch(threshold=0.3).fit(fps)
    assert tree.get_cluster_mol_ids() == ref.get_cluster_mol_ids()


def test_a_fresh_build_directory_gets_one_hashed_library(monkeypatch, tmp_path) -> None:
    if _build.shutil.which(os.environ.get("CXX") or "g++") is None:
        pytest.skip("no C++ compiler")
    monkeypatch.setattr(_build, "_BUILD_DIR", tmp_path / "build")
    assert _build.host_library_path("bblean_native.cpp") is None
    path = _build.build_host_library("bblean_native.cpp")
    assert _build.build_seconds["bblean_native.cpp"] > 0
    assert [p.name for p in (tmp_path / "build").iterdir()] == [path.name]
    assert _build.build_host_library("bblean_native.cpp") == path
    assert _build.build_seconds["bblean_native.cpp"] == 0.0  # reused
    monkeypatch.setattr(_build, "CXX_FLAGS", [*_build.CXX_FLAGS, "-DOTHER_FLAGS"])
    assert _build.host_library_path("bblean_native.cpp") is None  # the name carries the flags


def test_bitbirch_imports_without_jax_and_scikit_learn() -> None:
    code = (
        "import sys\n"
        "sys.modules['sklearn'] = None\n"
        "from bblean_tpu_torch import BitBirch, set_merge\n"
        "from bblean_tpu_torch.fingerprints import make_fake_fingerprints\n"
        "tree = BitBirch(threshold=0.3).fit(make_fake_fingerprints(200, seed=1))\n"
        "tree.global_clustering(3, method='kmeans-tpu', device='cpu')\n"
        "assert len(tree.get_cluster_mol_ids(global_clusters=True)) == 3\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'bblean_tpu'))\n"
        "assert not bad, bad\n"
        "print(tree.engine_name)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-W", "ignore", "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() in ("native", "python")
