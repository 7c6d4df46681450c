r"""Nothing under ``perfbench/`` imports JAX or the JAX package, compared by
each module's top-level name taken whole (the port's name begins with the
JAX package's), and the reference imports nothing of the port."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
SOURCES = sorted(HERE.rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "bblean_tpu"}


def _tops(path: Path) -> set[str]:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add((node.module or "").split(".")[0])
    return out


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_and_no_jax_package(path):
    assert not _tops(path) & FORBIDDEN


@pytest.mark.parametrize("name", ["reference.py", "library.py"])
def test_the_reference_and_the_generator_import_nothing_of_the_port(name):
    assert _tops(HERE / name) <= {"__future__", "numpy", "torch", "perfbench"}
    for dep in _tops(HERE / name) & {"perfbench"}:
        assert dep == "perfbench"
    # What they take from perfbench is the generator's bit packing alone
    assert "bblean_tpu_torch" not in (HERE / name).read_text()


def test_the_names_are_compared_whole():
    import perfbench.run as run

    assert "bblean_tpu_torch".split(".")[0] not in run.FORBIDDEN
    assert set(run.FORBIDDEN) == FORBIDDEN
