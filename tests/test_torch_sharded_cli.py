r"""``run --engine sharded`` of the port's command line against the JAX
package's, on the CPU.

The same arguments as ``tests/test_cli.py::test_run_sharded_engine`` go
through ``bblean_tpu.cli.main`` on JAX's eight virtual CPU devices and
through ``bblean_tpu_torch.cli.main`` with ``--device cpu`` on eight CPU
shards (the port's ``get_mesh`` is patched to name the CPU eight times, as
``tests/conftest.py`` gives JAX eight devices).  The run directories must
hold the same clusters in the same order, the same packed centroids and the
same ``config.json`` keys; everything compared is integer-valued.
"""

import json
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch
from click.testing import CliRunner

import jax

import bblean_tpu_torch.parallel as port_parallel
from bblean_tpu.cli import main as jax_main
from bblean_tpu.fingerprints import make_fake_fingerprints
from bblean_tpu_torch.cli import main as torch_main

torch.set_num_threads(2)

SEED = 12620509540149709235
COMMON = ["-t", "0.3", "--engine", "sharded", "--batch-size", "64", "--no-monitor-mem", "-V"]
# config.json keys that describe the host or the device, not the run
HOST_KEYS = {
    "native_extensions_enabled", "native_extensions_installed",
    "total_memory_gib", "initial_available_memory_gib", "platform", "cpu",
    "accelerators", "numpy_version", "torch_version", "python_version",
    "device", "device_memory",
}

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs >= 8 devices (virtual CPU mesh)"
)


def _load(path: Path):
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.fixture()
def eight_cpu_shards(monkeypatch):
    real = port_parallel.get_mesh
    monkeypatch.setattr(
        port_parallel, "get_mesh", lambda device="cuda": real(devices=[device] * 8)
    )


@pytest.mark.parametrize(
    "extra",
    [[], ["--refine-num", "1", "--refine-threshold-change", "-0.05"],
     ["--recluster-rounds", "1", "--no-recluster-shuffle"]],
    ids=["fit-merge", "refine", "recluster"],
)
def test_run_sharded_engine_equals_jax_cli(tmp_path, eight_cpu_shards, extra) -> None:
    input_ = tmp_path / "fps.npy"
    np.save(input_, make_fake_fingerprints(300, seed=SEED))
    out_j, out_t = tmp_path / "out-jax", tmp_path / "out-torch"
    argv = ["run", str(input_), *COMMON, *extra]
    result = CliRunner().invoke(jax_main, [*argv, "-o", str(out_j)])
    assert result.exit_code == 0, result.output
    torch_main([*argv, "-o", str(out_t), "--device", "cpu"])

    clusters = _load(out_t / "clusters.pkl")
    assert clusters == _load(out_j / "clusters.pkl")
    assert sorted(i for c in clusters for i in c) == list(range(300))
    sizes = [len(c) for c in clusters]
    assert sizes == sorted(sizes, reverse=True)
    got = _load(out_t / "cluster-centroids-packed.pkl")
    ref = _load(out_j / "cluster-centroids-packed.pkl")
    assert len(got) == len(ref) == len(clusters)
    np.testing.assert_array_equal(np.stack(got), np.stack(ref))

    cfg_j = json.loads((out_j / "config.json").read_text())
    cfg_t = json.loads((out_t / "config.json").read_text())
    assert set(cfg_t) - HOST_KEYS == set(cfg_j) - HOST_KEYS
    for key in set(cfg_j) - HOST_KEYS - {"out_dir"}:
        assert cfg_t[key] == cfg_j[key], key
    assert cfg_t["n_devices"] == 8 and cfg_t["n_clusters"] == len(clusters)
    assert cfg_t["device_table_bytes_per_device"] > 0
    timings = json.loads((out_t / "timings.json").read_text())
    assert timings["total"] >= timings["fit"] + timings["merge"] > 0


def test_run_sharded_on_one_cpu_shard_and_two_files(tmp_path, capsys) -> None:
    r"""``--device cpu`` alone is a mesh of one CPU shard; two files stream
    through one forest with consecutive molecule ids."""
    fps = make_fake_fingerprints(300, n_features=512, seed=SEED)
    d = tmp_path / "inputs"
    d.mkdir()
    np.save(d / "a.npy", fps[:170])
    np.save(d / "b.npy", fps[170:])
    out = tmp_path / "out"
    argv = ["-t", "0.3", "--engine", "sharded", "--batch-size", "64", "--no-monitor-mem"]
    torch_main(["run", str(d), *argv, "-o", str(out), "--device", "cpu"])
    assert "Sharding over 1 device(s)" in capsys.readouterr().out
    clusters = _load(out / "clusters.pkl")
    assert sorted(i for c in clusters for i in c) == list(range(300))
    cfg = json.loads((out / "config.json").read_text())
    assert cfg["n_devices"] == 1 and cfg["engine"] == "sharded"
    # One shard has nothing to merge: the batch engine's clusters
    out_b = tmp_path / "out-batch"
    torch_main([
        "run", str(d), "-t", "0.3", "--engine", "batch", "--batch-size", "64",
        "--no-monitor-mem", "-V", "-o", str(out_b), "--device", "cpu",
    ])
    assert sorted(map(len, clusters)) == sorted(map(len, _load(out_b / "clusters.pkl")))


def test_run_sharded_cuda_without_a_card_raises(tmp_path) -> None:
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is available")
    input_ = tmp_path / "fps.npy"
    np.save(input_, make_fake_fingerprints(60, seed=SEED))
    out = tmp_path / "out"
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        torch_main(["run", str(input_), *COMMON, "-o", str(out)])
    assert not out.exists()
