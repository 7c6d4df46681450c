r"""The port's analysis and featurization commands against the JAX
package's, on the CPU.

The same arguments go through ``bblean_tpu.cli.main`` (click's CliRunner)
and through ``bblean_tpu_torch.cli.main``: ``summary`` prints the same lines
and writes the same metrics file on the same run directory; the plot
commands write their PNGs; ``fps-from-smiles`` in its three modes (serial,
one file per batch, one shared-memory array) writes byte-equal ``.npy``
files under the RDKit stub of ``tests/test_shm_featurization.py`` applied to
both packages' modules (the pool run in-process so the stub applies), with
and without ``--skip-invalid``; without RDKit both exit non-zero; and
``--version`` prints click's line under the port's name.
"""

import pickle
import sys

import numpy as np
import pytest
from click.testing import CliRunner

import bblean_tpu.fingerprints as jfp
import bblean_tpu_torch.fingerprints as tfp
from bblean_tpu.cli import main as jax_main
from bblean_tpu.fingerprints import make_fake_fingerprints
from bblean_tpu_torch.cli import main as torch_main

from test_shm_featurization import (
    _FakeCtx,
    _FakeGenerator,
    _fake_mol_from_smiles,
    _fake_sanitize,
    _smi_bits,
)

SEED = 12620509540149709235


def _torch_run(argv, capsys) -> tuple[int, str, str]:
    r"""The port's ``main(argv)``: exit code, standard output, standard
    error."""
    code = 0
    try:
        torch_main(argv)
    except SystemExit as exc:
        code = exc.code
    out = capsys.readouterr()
    return code, out.out, out.err


@pytest.fixture(scope="module")
def run_dirs(tmp_path_factory):
    r"""Run directories written by the port's ``run`` (exact engine): one
    input file, two input files, and one without ``input-fps/``."""
    base = tmp_path_factory.mktemp("runs")
    fps = make_fake_fingerprints(400, seed=SEED)
    np.save(base / "fps.npy", fps)
    parts = base / "parts"
    parts.mkdir()
    np.save(parts / "a.npy", fps[:150])
    np.save(parts / "b.npy", fps[150:])
    dirs = {}
    for name, input_ in (("one", base / "fps.npy"), ("two", parts)):
        dirs[name] = base / f"out-{name}"
        torch_main(["run", str(input_), "-o", str(dirs[name]), "-t", "0.3", "--no-monitor-mem", "-V"])
    dirs["bare"] = base / "out-bare"
    dirs["bare"].mkdir()
    (dirs["bare"] / "clusters.pkl").write_bytes((dirs["one"] / "clusters.pkl").read_bytes())
    return dirs


@pytest.mark.parametrize(
    "which,extra",
    [
        ("one", []),
        ("one", ["--top", "5", "--chi", "--dbi", "--dunn"]),
        ("two", ["--top", "30", "--min-size", "2", "--chi", "--no-dbi", "--dunn"]),
        ("bare", ["--top", "3", "--chi"]),
    ],
)
def test_summary_prints_what_jax_prints(run_dirs, tmp_path, capsys, which, extra) -> None:
    run_dir = run_dirs[which]
    metrics = tmp_path / "metrics.csv"
    argv = ["summary", str(run_dir), *extra, "--dump-metrics", str(metrics)]
    ref = CliRunner().invoke(jax_main, argv)
    assert ref.exit_code == 0, ref.output
    ref_csv = metrics.read_bytes()
    metrics.unlink()
    code, out, err = _torch_run(argv, capsys)
    assert code == 0, err
    assert out == ref.output
    assert metrics.read_bytes() == ref_csv
    assert "Total fingerprints: 400" in out
    assert ("iSIM" in out) == (which != "bare")


def test_summary_without_clusters_exits_1(tmp_path, capsys) -> None:
    code, _out, err = _torch_run(["summary", str(tmp_path)], capsys)
    assert code == 1 and "clusters.pkl not found" in err


@pytest.mark.parametrize("kind", ["summary", "pops", "pca", "tsne"])
def test_plot_commands_write_png(run_dirs, tmp_path, capsys, kind) -> None:
    out = tmp_path / f"{kind}.png"
    argv = [f"plot-{kind}", str(run_dirs["two"]), "--top", "4", "-o", str(out)]
    code, stdout, err = _torch_run(argv + (["--device", "cpu"] if kind == "tsne" else []), capsys)
    assert code == 0, err
    assert out.stat().st_size > 0 and stdout == f"Wrote {out}\n"


def test_plot_command_default_output_and_missing_packages(run_dirs, capsys, monkeypatch) -> None:
    r"""Without ``-o`` the PNG lands in the run directory; without
    matplotlib, or umap-learn for ``plot-umap``, the command exits 1 with
    an error naming the package; on the CPU the t-SNE needs ``--device
    cpu``."""
    import torch

    run_dir = run_dirs["one"]
    code, _out, err = _torch_run(["plot-pca", str(run_dir), "--top", "3"], capsys)
    assert code == 0, err
    assert (run_dir / "pca.png").stat().st_size > 0
    monkeypatch.setitem(sys.modules, "umap", None)
    code, _out, err = _torch_run(["plot-umap", str(run_dir)], capsys)
    assert code == 1 and "umap-learn is required" in err
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            torch_main(["plot-tsne", str(run_dir), "--top", "3"])
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    for kind in ("summary", "pops", "pca", "tsne", "umap"):
        code, _out, err = _torch_run([f"plot-{kind}", str(run_dir)], capsys)
        assert code == 1 and "Error: matplotlib is required" in err, kind


# -- fps-from-smiles under the RDKit stub -----------------------------------------


@pytest.fixture
def stub_rdkit(monkeypatch):
    r"""``tests/test_shm_featurization.py``'s stub, on both packages."""
    import multiprocessing

    for mod in (jfp, tfp):
        monkeypatch.setattr(mod, "MolFromSmiles", _fake_mol_from_smiles, raising=False)
        monkeypatch.setattr(mod, "SanitizeMol", _fake_sanitize, raising=False)
        monkeypatch.setattr(mod, "_require_rdkit", lambda: None)
        monkeypatch.setattr(mod, "_get_generator", lambda kind, n: _FakeGenerator(n))
        monkeypatch.setattr(mod, "_get_sanitize_flags", lambda s: None)
        monkeypatch.setattr(mod, "_HAS_RDKIT", True)
    monkeypatch.setattr(multiprocessing, "get_context", lambda method=None: _FakeCtx())


def _smi_files(tmp_path, bad: bool) -> list:
    smiles = [f"C{i}" for i in range(45)]
    if bad:
        smiles[3], smiles[17], smiles[40] = "BAD3", "UGLY17", "BAD40"
    paths = [tmp_path / "a.smi", tmp_path / "b.smi"]
    paths[0].write_text("\n".join(f"{s} name{i}" for i, s in enumerate(smiles[:20])) + "\n\n")
    paths[1].write_text("\n".join(smiles[20:]) + "\n")
    return paths


def _files(d) -> dict:
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


@pytest.mark.parametrize(
    "mode", [[], ["-p", "2", "--batch-size", "16"], ["-p", "2", "--single-file", "--batch-size", "16"]],
    ids=["serial", "multi-file", "single-file"],
)
@pytest.mark.parametrize(
    "extra", [[], ["--skip-invalid"], ["--no-pack", "--out-name", "bits"]],
    ids=["valid", "skip-invalid", "unpacked"],
)
def test_fps_from_smiles_writes_the_jax_files(stub_rdkit, tmp_path, capsys, mode, extra) -> None:
    smi = _smi_files(tmp_path, bad="--skip-invalid" in extra)
    common = [*map(str, smi), "--n-features", "64", "-V", *mode, *extra]
    ref = CliRunner().invoke(jax_main, ["fps-from-smiles", *common, "-o", str(tmp_path / "jax")])
    assert ref.exit_code == 0, ref.output
    code, _out, err = _torch_run(["fps-from-smiles", *common, "-o", str(tmp_path / "port")], capsys)
    assert code == 0, err
    got, want = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert got == want
    name = "bits" if "--no-pack" in extra else "fps"
    rows = np.concatenate([np.load(tmp_path / "port" / f) for f in sorted(got) if f.startswith(name)])
    n_valid = 42 if "--skip-invalid" in extra else 45
    assert rows.shape == (n_valid, 64 if "--no-pack" in extra else 8)
    if not extra:
        bits = np.stack([_smi_bits(f"C{i}", 64) for i in range(45)])
        np.testing.assert_array_equal(rows, np.packbits(bits, axis=1))


def test_fps_from_smiles_invalid_without_skip_fails(stub_rdkit, tmp_path, capsys) -> None:
    smi = _smi_files(tmp_path, bad=True)
    ref = CliRunner().invoke(jax_main, ["fps-from-smiles", *map(str, smi), "-o", str(tmp_path)])
    with pytest.raises(ValueError, match="Unable to parse smiles BAD3"):
        torch_main(["fps-from-smiles", *map(str, smi), "-o", str(tmp_path)])
    assert ref.exit_code != 0 and isinstance(ref.exception, ValueError)


def test_fps_from_smiles_without_rdkit_exits_nonzero(tmp_path, capsys) -> None:
    r"""RDKit is not installed here: both commands fail; the port's exits
    1 with an error naming RDKit."""
    smi = tmp_path / "mols.smi"
    smi.write_text("CCO\nCCC\n")
    argv = ["fps-from-smiles", str(smi), "-o", str(tmp_path)]
    ref = CliRunner().invoke(jax_main, argv)
    if tfp._HAS_RDKIT:
        pytest.skip("RDKit is installed")
    assert ref.exit_code != 0 and isinstance(ref.exception, ImportError)
    for mode in ([], ["-p", "2", "--single-file"]):
        code, _out, err = _torch_run([*argv, *mode], capsys)
        assert code == 1 and "Error: RDKit is required" in err


def test_version(monkeypatch, capsys) -> None:
    r"""``--version`` prints click's line for ``bb`` under ``bb-torch``; the
    distribution is not installed in a checkout, and then it exits 1."""
    from importlib import metadata

    monkeypatch.setattr(metadata, "version", lambda name: {"bblean-tpu": "0.1.0"}[name])
    ref = CliRunner().invoke(jax_main, ["--version"])
    assert ref.exit_code == 0 and ref.output == "bb, version 0.1.0\n"
    assert _torch_run(["--version"], capsys) == (0, "bb-torch, version 0.1.0\n", "")

    def missing(name):
        raise metadata.PackageNotFoundError(name)

    monkeypatch.setattr(metadata, "version", missing)
    code, out, err = _torch_run(["--version"], capsys)
    assert code == 1 and out == "" and "'bblean-tpu' is not installed" in err


def test_run_dir_clusters_are_the_ones_summarised(run_dirs) -> None:
    r"""The fixture's run directories hold every molecule once."""
    for name in ("one", "two"):
        with open(run_dirs[name] / "clusters.pkl", "rb") as f:
            clusters = pickle.load(f)
        assert sorted(i for c in clusters for i in c) == list(range(400))
