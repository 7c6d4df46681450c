r"""The port's command line against the JAX package's, on the CPU.

The same arguments go through ``bblean_tpu.cli.main`` (click's CliRunner)
and through ``bblean_tpu_torch.cli.main`` with ``--device cpu``; the run
directories must hold the same clusters (the same lists in the same
order), the same packed centroids and the same ``n_clusters``, and the
fingerprint-file commands must write the same files and print the same
facts.  Everything compared here is integer-valued, so the comparisons are
exact.
"""

import json
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch
from click.testing import CliRunner

from bblean_tpu.cli import main as jax_main
from bblean_tpu.fingerprints import make_fake_fingerprints
from bblean_tpu_torch.cli import main as torch_main

SEED = 12620509540149709235
# Narrow rows keep the engines' tables small (the run's capacity has a floor
# of 8,192 clusters whatever the input)
N_FEATURES = 512
# A small batch keeps the engines' tables, and JAX's compiles, small; the
# same for every case, so that JAX compiles its programs once
COMMON = ["-t", "0.3", "--engine", "batch", "--batch-size", "64", "--no-monitor-mem", "-V"]
# config.json keys that describe the host or the device, not the run
HOST_KEYS = {
    "native_extensions_enabled", "native_extensions_installed",
    "total_memory_gib", "initial_available_memory_gib", "platform", "cpu",
    "accelerators", "numpy_version", "torch_version", "python_version",
    "device", "device_memory", "host_engine",
}


def _load(path: Path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _run_both(tmp_path: Path, input_: Path, extra: list[str]) -> tuple[Path, Path]:
    out_j, out_t = tmp_path / "out-jax", tmp_path / "out-torch"
    argv = ["run", str(input_), *COMMON, *extra]
    result = CliRunner().invoke(jax_main, [*argv, "-o", str(out_j)])
    assert result.exit_code == 0, result.output
    torch_main([*argv, "-o", str(out_t), "--device", "cpu"])
    return out_j, out_t


def _write_inputs(tmp_path: Path, kind: str, num: int = 300) -> Path:
    fps = make_fake_fingerprints(num, n_features=N_FEATURES, seed=SEED)
    if kind == "dir":
        d = tmp_path / "inputs"
        d.mkdir()
        np.save(d / "a.npy", fps[:170])
        np.save(d / "b.npy", fps[170:])
        return d
    if kind == "unpacked":
        fps = np.unpackbits(fps, axis=1)
    path = tmp_path / "fps.npy"
    np.save(path, fps)
    return path


@pytest.mark.parametrize(
    "kind,extra,n_mols",
    [
        ("file", [], 300),
        ("dir", [], 300),
        ("file", ["--refine-num", "2"], 300),
        ("dir", ["--refine-num", "1"], 300),
        ("file", ["--recluster-rounds", "1", "--no-recluster-shuffle"], 300),
        ("unpacked", ["--unpacked-input"], 300),
        ("file", ["--max-fps", "130"], 130),
        ("file", ["--no-save-centroids"], 300),
    ],
    ids=["one-file", "two-files", "refine-2", "two-files-refine", "recluster",
         "unpacked", "max-fps", "no-centroids"],
)
def test_run_batch_engine_equals_jax_cli(tmp_path, kind, extra, n_mols) -> None:
    input_ = _write_inputs(tmp_path, kind)
    out_j, out_t = _run_both(tmp_path, input_, extra)

    clusters = _load(out_t / "clusters.pkl")
    assert clusters == _load(out_j / "clusters.pkl")
    assert sorted(i for c in clusters for i in c) == list(range(n_mols))
    sizes = [len(c) for c in clusters]
    assert sizes == sorted(sizes, reverse=True)

    cents_j, cents_t = (o / "cluster-centroids-packed.pkl" for o in (out_j, out_t))
    assert cents_t.exists() == cents_j.exists() == ("--no-save-centroids" not in extra)
    if cents_t.exists():
        got, ref = _load(cents_t), _load(cents_j)
        assert len(got) == len(ref) == len(clusters)
        np.testing.assert_array_equal(np.stack(got), np.stack(ref))

    cfg_j = json.loads((out_j / "config.json").read_text())
    cfg_t = json.loads((out_t / "config.json").read_text())
    assert set(cfg_t) - HOST_KEYS == set(cfg_j) - HOST_KEYS
    assert cfg_t["n_clusters"] == cfg_j["n_clusters"] == len(clusters)
    for key in set(cfg_j) - HOST_KEYS - {"out_dir"}:
        assert cfg_t[key] == cfg_j[key], key
    assert cfg_t["device"] == "cpu" and cfg_t["accelerators"] == []

    timings = json.loads((out_t / "timings.json").read_text())
    assert timings["total"] > 0 and timings["fit"] > 0
    links_j = sorted(p.name for p in (out_j / "input-fps").iterdir())
    links_t = sorted((out_t / "input-fps").iterdir())
    assert [p.name for p in links_t] == links_j
    assert all(p.is_symlink() and p.resolve().exists() for p in links_t)


def test_run_overwrite_protection_and_copy(tmp_path, capsys) -> None:
    input_ = _write_inputs(tmp_path, "file", 60)
    out = tmp_path / "out"
    argv = ["run", str(input_), *COMMON, "-o", str(out), "--device", "cpu"]
    torch_main(argv)
    with pytest.raises(SystemExit) as err:
        torch_main(argv)
    assert err.value.code == 1
    assert "pass --overwrite" in capsys.readouterr().err
    torch_main([*argv, "--overwrite", "--copy"])
    # The link made by the first run stays: an existing entry is kept
    assert (out / "input-fps" / "fps.npy").is_symlink()


def test_run_verbose_prints_banner_and_config(tmp_path, capsys) -> None:
    r"""The port's console text names no other accelerator."""
    input_ = _write_inputs(tmp_path, "file", 60)
    out = tmp_path / "out"
    torch_main(
        ["run", str(input_), "-t", "0.3", "--engine", "batch", "--batch-size", "64",
         "--no-monitor-mem", "-o", str(out), "--device", "cpu"]
    )
    printed = capsys.readouterr().out
    assert "threshold" in printed and "Outputs in:" in printed
    assert "Auto-tuned fanout=192 for 60 rows" in printed
    assert "PyTorch + CUDA" in printed and "TPU" not in printed


@pytest.mark.parametrize("engine", ["exact", None])
def test_engines_not_ported_are_refused_by_name(tmp_path, capsys, engine) -> None:
    r"""``--engine`` keeps its three choices and its default (exact), and no
    choice is refused any more: every engine is ported.  ``exact``, by name
    or by default, runs ``BitBirch`` on the host (no device asked for) and
    gives the JAX CLI's clusters."""
    input_ = _write_inputs(tmp_path, "file")
    out_t, out_j = tmp_path / "out", tmp_path / "out-jax"
    argv = ["run", str(input_), "-t", "0.3", "--no-monitor-mem", "-V"]
    if engine is not None:
        argv += ["--engine", engine]
    torch_main([*argv, "-o", str(out_t)])
    assert "not yet ported" not in capsys.readouterr().err
    result = CliRunner().invoke(jax_main, [*argv, "-o", str(out_j)])
    assert result.exit_code == 0, result.output
    clusters = _load(out_t / "clusters.pkl")
    assert clusters == _load(out_j / "clusters.pkl")
    assert sorted(i for c in clusters for i in c) == list(range(300))
    cfg = json.loads((out_t / "config.json").read_text())
    assert cfg["engine"] == "exact" and cfg["host_engine"] in ("native", "python")
    assert "device" not in cfg


def test_unknown_engine_and_missing_command_are_usage_errors(capsys) -> None:
    for argv in (["run", "x.npy", "--engine", "fast"], []):
        with pytest.raises(SystemExit) as err:
            torch_main(argv)
        assert err.value.code == 2
    capsys.readouterr()


def test_device_cuda_without_a_card_raises(tmp_path) -> None:
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is available")
    input_ = _write_inputs(tmp_path, "file")
    out = tmp_path / "out"
    for device in ([], ["--device", "cuda"]):  # cuda is the default
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            torch_main(["run", str(input_), *COMMON, "-o", str(out), *device])
    assert not out.exists()


def test_no_input_files_is_an_error(tmp_path, capsys) -> None:
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(SystemExit) as err:
        torch_main(["run", str(empty), *COMMON, "--device", "cpu", "-o", str(tmp_path / "o")])
    assert err.value.code == 1
    assert "No *.npy files found" in capsys.readouterr().err


# -- fingerprint file commands ---------------------------------------------------


def _squash(text: str) -> str:
    return "".join(text.split())


def test_fps_info_prints_the_same_facts(tmp_path, capsys) -> None:
    good = tmp_path / "fps.npy"
    np.save(good, make_fake_fingerprints(300, seed=SEED))
    bad = tmp_path / "bad.npy"
    np.save(bad, np.zeros((3, 4, 5), np.float32))
    result = CliRunner().invoke(jax_main, ["fps-info", str(good), str(bad)])
    assert result.exit_code == 0, result.output
    torch_main(["fps-info", str(good), str(bad)])
    printed = capsys.readouterr().out
    assert _squash(printed) == _squash(result.output)
    assert "Valid fingerprint file" in printed and "Num. fingerprints: 300" in printed
    assert "Invalid fingerprint file" in printed


@pytest.mark.parametrize("how", [["-n", "4"], ["--split-size", "110"]])
def test_fps_split_and_merge_write_the_same_files(tmp_path, capsys, how) -> None:
    src = tmp_path / "fps.npy"
    np.save(src, make_fake_fingerprints(300, seed=SEED))
    out_j, out_t = tmp_path / "shards-jax", tmp_path / "shards-torch"
    result = CliRunner().invoke(jax_main, ["fps-split", str(src), *how, "-o", str(out_j)])
    assert result.exit_code == 0, result.output
    torch_main(["fps-split", str(src), *how, "-o", str(out_t)])
    printed = capsys.readouterr().out
    assert printed.replace(str(out_t), "") == result.output.replace(str(out_j), "")
    shards_j, shards_t = sorted(out_j.glob("*.npy")), sorted(out_t.glob("*.npy"))
    assert [p.name for p in shards_t] == [p.name for p in shards_j]
    for a, b in zip(shards_t, shards_j):
        np.testing.assert_array_equal(np.load(a), np.load(b))

    merged = tmp_path / "merged.npy"
    torch_main(["fps-merge", *map(str, shards_t), "-o", str(merged)])
    assert "Wrote 300 fingerprints" in capsys.readouterr().out
    np.testing.assert_array_equal(np.load(merged), np.load(src))


def test_fps_split_needs_exactly_one_size(tmp_path, capsys) -> None:
    src = tmp_path / "fps.npy"
    np.save(src, make_fake_fingerprints(20, seed=1))
    for how in ([], ["-n", "2", "--split-size", "5"]):
        with pytest.raises(SystemExit) as err:
            torch_main(["fps-split", str(src), *how])
        assert err.value.code == 1
    assert "exactly one of" in capsys.readouterr().err


def test_fps_merge_rejects_mixed_widths(tmp_path, capsys) -> None:
    a, b = tmp_path / "a.npy", tmp_path / "b.npy"
    np.save(a, make_fake_fingerprints(10, seed=1))
    np.save(b, make_fake_fingerprints(10, n_features=512, seed=1))
    with pytest.raises(SystemExit) as err:
        torch_main(["fps-merge", str(a), str(b), "-o", str(tmp_path / "m.npy")])
    assert err.value.code == 1
    assert "Incompatible fingerprint widths" in capsys.readouterr().err


def test_fps_shuffle_writes_the_same_file(tmp_path, capsys) -> None:
    fps = make_fake_fingerprints(300, seed=SEED)
    dir_j, dir_t = tmp_path / "j", tmp_path / "t"
    for d in (dir_j, dir_t):
        d.mkdir()
        np.save(d / "fps.npy", fps)
    argv = ["--seed", "3", "--suffix", "mixed"]
    result = CliRunner().invoke(jax_main, ["fps-shuffle", str(dir_j / "fps.npy"), *argv])
    assert result.exit_code == 0, result.output
    torch_main(["fps-shuffle", str(dir_t / "fps.npy"), *argv])
    assert "fps.mixed.npy" in capsys.readouterr().out
    got = np.load(dir_t / "fps.mixed.npy")
    np.testing.assert_array_equal(got, np.load(dir_j / "fps.mixed.npy"))
    assert not (got == fps).all()
