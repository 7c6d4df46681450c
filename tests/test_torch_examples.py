r"""The port's examples (``bblean_tpu_torch/examples/``) against the JAX
package's scripts (``examples/``), on the CPU.

Each JAX script runs as it is, in a subprocess (``multi_device`` on JAX's
8 virtual CPU devices), and its twin runs with ``--device cpu``
(``--shards 8`` for ``multi_device``) in another working directory, both
at once.  Standard output must be equal line for line, but for
``multi_device``'s ``devices:`` line, which names each package's device.
Both sides run the host engines or the sharded engine on the same seeded
data, so every printed number is equal.  ``quickstart``'s
``assignments.csv`` must be byte-equal, and each ``tree.pkl`` must load in
its own package with equal assignments.
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import bblean_tpu
import bblean_tpu_torch

ROOT = Path(__file__).resolve().parent.parent
NAMES = ["quickstart", "best_practices", "dataset_splitting", "multi_device"]


def _env(**extra: str) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(ROOT), env.get("PYTHONPATH")) if p
    )
    # No persistent JAX cache: the scripts would write it under $HOME
    env["BBLEAN_TPU_NO_JAX_CACHE"] = "1"
    env.update(extra)
    return env


def _start(argv: list[str], cwd: Path, env: dict) -> subprocess.Popen:
    cwd.mkdir()
    return subprocess.Popen(
        [sys.executable, *argv], cwd=cwd, env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
    )


def _finish(proc: subprocess.Popen, what: str) -> list[str]:
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, f"{what} exited {proc.returncode}:\n{err}"
    return out.splitlines()


@pytest.mark.parametrize("name", NAMES)
def test_example_prints_what_the_jax_script_prints(tmp_path: Path, name: str) -> None:
    jax_env = _env(JAX_PLATFORMS="cpu")
    twin_argv = ["-m", f"bblean_tpu_torch.examples.{name}", "--device", "cpu"]
    if name == "multi_device":
        jax_env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        twin_argv += ["--shards", "8"]
    jax_dir, twin_dir = tmp_path / "jax", tmp_path / "torch"
    jax_proc = _start([str(ROOT / "examples" / f"{name}.py")], jax_dir, jax_env)
    twin_proc = _start(twin_argv, twin_dir, _env())
    want = _finish(jax_proc, f"examples/{name}.py")
    got = _finish(twin_proc, f"bblean_tpu_torch.examples.{name}")

    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        if name == "multi_device" and w.startswith("devices:"):
            assert g == "devices: 8 x cpu", g
            continue
        assert g == w
    if name == "quickstart":
        csv = (twin_dir / "assignments.csv").read_bytes()
        assert csv == (jax_dir / "assignments.csv").read_bytes()
        assigned = []
        for pkg, where in ((bblean_tpu, jax_dir), (bblean_tpu_torch, twin_dir)):
            with open(where / "tree.pkl", "rb") as f:
                tree = pickle.load(f)
            assert isinstance(tree, pkg.BitBirch), type(tree)
            assigned.append(tree.get_assignments())
        np.testing.assert_array_equal(assigned[1], assigned[0])


@pytest.mark.parametrize("name", NAMES)
def test_example_on_cuda_raises_without_a_card(monkeypatch, name: str) -> None:
    r"""The default ``--device cuda`` raises on a machine without a card
    before any work: nothing gives way to the CPU."""
    import importlib

    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module = importlib.import_module(f"bblean_tpu_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        module.main([])
