r"""The port's ``multiround`` workflow and the command line's host commands
(``run`` with its default engine, ``multiround``) against the JAX package's.

The same files and the same arguments go through both packages; the pickles
they write (``clusters.pkl``, ``cluster-centroids-packed.pkl``) must be
byte-equal, with the native engine and with ``BBLEAN_TPU_NO_EXTENSIONS=1``.
The pickles hold Python ints and uint8 arrays, so there is no tolerance.
"""

import json
import pickle
from pathlib import Path

import numpy as np
import pytest
from click.testing import CliRunner

from bblean_tpu.cli import main as jax_main
from bblean_tpu.fingerprints import make_fake_fingerprints
from bblean_tpu.multiround import run_multiround_bitbirch as jax_multiround
from bblean_tpu_torch.cli import main as torch_main
from bblean_tpu_torch.engine.native import native_engine_available
from bblean_tpu_torch.multiround import run_multiround_bitbirch as torch_multiround

SEED = 12620509540149709235
ENGINES = ["python", "native"]
PICKLES = ("clusters.pkl", "cluster-centroids-packed.pkl")
# config.json keys that describe the host, the device or the port alone
HOST_KEYS = {
    "native_extensions_enabled", "native_extensions_installed",
    "total_memory_gib", "initial_available_memory_gib", "platform", "cpu",
    "accelerators", "numpy_version", "torch_version", "python_version",
    "device", "device_memory", "host_engine",
    "multiprocessing_start_method", "visible_cpu_cores",
}

# The golden of ``tests/test_multiround.py``
EXPECT_TOP2 = [
    [368, 414, 422, 423, 520, 549, 581, 609, 625, 683, 622, 709, 761, 770,
     789, 813, 831, 989],
    [23, 285, 209, 213, 276, 294, 316, 319, 358],
]


@pytest.fixture
def engine(request, monkeypatch):
    r"""Make both packages pick one host engine in this process.  A pool's
    workers take their environment from the fork server, which may have
    started under an earlier test's: there the engine may be the other one,
    and the pickles must be the same all the same."""
    name = request.param
    if name == "native":
        monkeypatch.delenv("BBLEAN_TPU_NO_EXTENSIONS", raising=False)
        monkeypatch.delenv("BITBIRCH_NO_EXTENSIONS", raising=False)
        if not native_engine_available():
            pytest.skip("no C++ compiler: the native library cannot be built")
    else:
        monkeypatch.setenv("BBLEAN_TPU_NO_EXTENSIONS", "1")
    return name


def _load(path: Path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _make_shards(dir: Path) -> list[Path]:
    dir.mkdir(exist_ok=True)
    for seed in range(1, 21, 2):
        np.save(dir / f"fps.{str(seed).zfill(4)}.npy", make_fake_fingerprints(100, seed=seed))
    return sorted(dir.glob("*.npy"))


def _assert_same_pickles(out_t: Path, out_j: Path, centroids: bool = True) -> list:
    for name in PICKLES[: 2 if centroids else 1]:
        assert (out_t / name).read_bytes() == (out_j / name).read_bytes(), name
    assert (out_t / PICKLES[1]).exists() == (out_j / PICKLES[1]).exists() == centroids
    return _load(out_t / "clusters.pkl")


# -- multiround, the library function --------------------------------------------------


@pytest.mark.parametrize("engine", ENGINES, indirect=True)
@pytest.mark.parametrize("num_processes", [1, 2])
def test_multiround_golden_equals_jax_package(tmp_path, engine, num_processes) -> None:
    files = _make_shards(tmp_path / "shards")
    outs = []
    for name, run in (("torch", torch_multiround), ("jax", jax_multiround)):
        out = tmp_path / f"out-{name}"
        out.mkdir()
        timer = run(
            files, out, num_initial_processes=num_processes, bin_size=2,
            threshold=0.65, midsection_merge_criterion="tolerance-legacy",
        )
        assert set(timer.timings) == {"total", "round-1", "round-2", "round-3"}
        outs.append(out)
    clusters = _assert_same_pickles(*outs)
    assert clusters[:2] == EXPECT_TOP2
    assert all(len(c) == 1 for c in clusters[2:20])
    assert sorted(i for c in clusters for i in c) == list(range(1000))
    assert not list(outs[0].glob("round-*"))


@pytest.mark.parametrize("engine", ENGINES, indirect=True)
@pytest.mark.parametrize(
    "kwargs",
    [
        dict(bin_size=3, refinement_before_midsection="none", save_centroids=False, cleanup=False),
        dict(bin_size=4, refinement_before_midsection="split", threshold=0.3,
             split_largest_after_each_midsection_round=True, num_midsection_rounds=2),
        dict(bin_size=10, threshold=0.3, midsection_threshold_change=0.05,
             final_merge_criterion="diameter", save_tree=True, max_fps=60),
    ],
    ids=["no-refinement", "split-largest", "final-merge-and-tree"],
)
def test_multiround_options_equal_jax_package(tmp_path, engine, kwargs) -> None:
    files = _make_shards(tmp_path / "shards")
    outs = []
    for name, run in (("torch", torch_multiround), ("jax", jax_multiround)):
        out = tmp_path / f"out-{name}"
        out.mkdir()
        run(files, out, num_initial_processes=1, **{"threshold": 0.65, **kwargs})
        outs.append(out)
    clusters = _assert_same_pickles(*outs, centroids=kwargs.get("save_centroids", True))
    n_mols = 600 if "max_fps" in kwargs else 1000
    assert len({i for c in clusters for i in c}) == sum(len(c) for c in clusters) == n_mols
    rounds_t = sorted(p.name for p in outs[0].glob("round-*"))
    assert rounds_t == sorted(p.name for p in outs[1].glob("round-*"))
    assert bool(rounds_t) == (kwargs.get("cleanup") is False)
    for name in rounds_t:
        if name.endswith(".npy"):
            np.testing.assert_array_equal(np.load(outs[0] / name), np.load(outs[1] / name))
    if kwargs.get("save_tree"):
        from bblean_tpu_torch import BitBirch

        tree = BitBirch.load(outs[0] / "bitbirch.pkl")
        assert tree.engine_name == engine
        assert tree.get_cluster_mol_ids() == clusters


def test_multiround_rejects_more_midsection_processes(tmp_path) -> None:
    files = _make_shards(tmp_path / "shards")
    with pytest.raises(ValueError, match="midsection"):
        torch_multiround(files, tmp_path, num_initial_processes=2, num_midsection_processes=3)


# -- the command line: the same argv through both CLIs ------------------------------------


def _write_inputs(tmp_path: Path, kind: str, num: int = 600) -> Path:
    fps = make_fake_fingerprints(num, seed=SEED)
    if kind == "dir":
        d = tmp_path / "inputs"
        d.mkdir()
        np.save(d / "a.npy", fps[:350])
        np.save(d / "b.npy", fps[350:])
        return d
    if kind == "unpacked":
        fps = np.unpackbits(fps, axis=1)
    path = tmp_path / "fps.npy"
    np.save(path, fps)
    return path


def _run_both(tmp_path: Path, argv: list[str]) -> tuple[Path, Path]:
    out_j, out_t = tmp_path / "out-jax", tmp_path / "out-torch"
    result = CliRunner().invoke(jax_main, [*argv, "-o", str(out_j)])
    assert result.exit_code == 0, result.output
    torch_main([*argv, "-o", str(out_t)])
    return out_t, out_j


def _assert_same_config(out_t: Path, out_j: Path, engine: str) -> dict:
    cfg_t = json.loads((out_t / "config.json").read_text())
    cfg_j = json.loads((out_j / "config.json").read_text())
    assert set(cfg_t) - HOST_KEYS == set(cfg_j) - HOST_KEYS
    for key in set(cfg_j) - HOST_KEYS - {"out_dir"}:
        assert cfg_t[key] == cfg_j[key], key
    assert cfg_t["host_engine"] == engine
    assert cfg_t["native_extensions_enabled"] == (engine == "native")
    assert cfg_t["native_extensions_enabled"] == cfg_j["native_extensions_enabled"]
    assert "device" not in cfg_t  # the host engines name no device
    timings_t = json.loads((out_t / "timings.json").read_text())
    timings_j = json.loads((out_j / "timings.json").read_text())
    assert set(timings_t) == set(timings_j) and timings_t["total"] > 0
    links = sorted((out_t / "input-fps").iterdir())
    assert [p.name for p in links] == sorted(p.name for p in (out_j / "input-fps").iterdir())
    assert all(p.is_symlink() and p.resolve().exists() for p in links)
    return cfg_t


@pytest.mark.parametrize("engine", ENGINES, indirect=True)
@pytest.mark.parametrize(
    "kind,extra,n_mols",
    [
        ("file", [], 600),
        ("file", ["--engine", "exact", "-b", "50", "-m", "radius", "-t", "0.5"], 600),
        ("dir", ["--refine-num", "2"], 600),
        ("file", ["--recluster-rounds", "2", "--no-recluster-shuffle",
                  "--set-refine-merge", "tolerance-legacy", "--refine-threshold-change", "0.05"], 600),
        ("unpacked", ["--unpacked-input", "--max-fps", "250", "--no-save-centroids"], 250),
        ("file", ["--save-tree", "--device", "cuda"], 600),
    ],
    ids=["default-engine", "exact-radius", "two-files-refine", "recluster", "unpacked-max-fps",
         "save-tree-device-ignored"],
)
def test_run_default_engine_equals_jax_cli(tmp_path, engine, kind, extra, n_mols) -> None:
    r"""``run`` with no ``--engine`` is the exact engine on both CLIs.
    ``--device`` is the port's own option: the exact engine ignores it (no
    card here, and none is asked for)."""
    input_ = _write_inputs(tmp_path, kind)
    argv = ["run", str(input_), "-t", "0.3", "--no-monitor-mem", "-V", *extra]
    out_j, out_t = tmp_path / "out-jax", tmp_path / "out-torch"
    jax_argv = [a for a in argv if a not in ("--device", "cuda")]
    result = CliRunner().invoke(jax_main, [*jax_argv, "-o", str(out_j)])
    assert result.exit_code == 0, result.output
    torch_main([*argv, "-o", str(out_t)])

    clusters = _assert_same_pickles(out_t, out_j, centroids="--no-save-centroids" not in extra)
    assert sorted(i for c in clusters for i in c) == list(range(n_mols))
    cfg = _assert_same_config(out_t, out_j, engine)
    assert cfg["command"] == "run" and cfg["engine"] == "exact"
    assert (out_t / "bitbirch.pkl").exists() == (out_j / "bitbirch.pkl").exists() == (
        "--save-tree" in extra
    )
    if "--save-tree" in extra:
        from bblean_tpu_torch import BitBirch

        tree = BitBirch.load(out_t / "bitbirch.pkl")
        assert tree.engine_name == engine and tree.num_fitted_fps == n_mols


@pytest.mark.parametrize("engine", ENGINES, indirect=True)
@pytest.mark.parametrize(
    "extra",
    [
        ["-p", "1", "--bin-size", "2", "-t", "0.65", "--set-midsection-merge", "tolerance-legacy"],
        ["-p", "2", "--num-midsection-processes", "2", "--bin-size", "3", "-t", "0.3",
         "--refinement", "split", "--split-largest", "--num-midsection-rounds", "2"],
        ["-p", "1", "-t", "0.3", "--refinement", "none", "--no-save-centroids", "--no-cleanup",
         "--set-final-merge", "diameter", "--midsection-threshold-change", "0.05", "--max-fps", "70"],
    ],
    ids=["golden-serial", "pool-split-largest", "no-refinement-no-cleanup"],
)
def test_multiround_equals_jax_cli(tmp_path, engine, extra) -> None:
    shards = tmp_path / "shards"
    _make_shards(shards)
    argv = ["multiround", str(shards), "--no-monitor-mem", "-V", *extra]
    out_t, out_j = _run_both(tmp_path, argv)
    clusters = _assert_same_pickles(out_t, out_j, centroids="--no-save-centroids" not in extra)
    n_mols = 700 if "--max-fps" in extra else 1000
    assert len({i for c in clusters for i in c}) == sum(len(c) for c in clusters) == n_mols
    if extra[:2] == ["-p", "1"] and "0.65" in extra:
        assert clusters[:2] == EXPECT_TOP2
    cfg = _assert_same_config(out_t, out_j, engine)
    assert cfg["command"] == "multiround"
    rounds = sorted(p.name for p in out_t.glob("round-*"))
    assert rounds == sorted(p.name for p in out_j.glob("round-*"))
    assert bool(rounds) == ("--no-cleanup" in extra)


def test_multiround_verbose_prints_its_config_and_rounds(tmp_path, capsys, monkeypatch) -> None:
    monkeypatch.setenv("BBLEAN_TPU_NO_EXTENSIONS", "1")
    shards = tmp_path / "shards"
    _make_shards(shards)
    out = tmp_path / "out"
    torch_main(["multiround", str(shards), "-p", "1", "--no-monitor-mem", "-o", str(out)])
    printed = capsys.readouterr().out
    assert "Multi-round config" in printed and "host_engine: python" in printed
    assert "Round 1 (initial)" in printed and "Round 3 (final)" in printed
    assert "PyTorch + CUDA" in printed and "TPU" not in printed
    with pytest.raises(SystemExit) as err:
        torch_main(["multiround", str(shards), "-p", "1", "--no-monitor-mem", "-o", str(out)])
    assert err.value.code == 1
    assert "pass --overwrite" in capsys.readouterr().err


def test_run_default_engine_verbose_prints_the_engine(tmp_path, capsys, monkeypatch) -> None:
    monkeypatch.setenv("BBLEAN_TPU_NO_EXTENSIONS", "1")
    input_ = _write_inputs(tmp_path, "file", 80)
    torch_main(["run", str(input_), "-t", "0.3", "--no-monitor-mem", "-o", str(tmp_path / "out")])
    printed = capsys.readouterr().out
    assert "engine: exact" in printed and "Outputs in:" in printed
    assert "Time elapsed" in printed or "total" in printed.lower()
