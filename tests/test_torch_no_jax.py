r"""The PyTorch port imports no JAX, and neither it nor ``chip_smoke.py``,
``chip_profile.py`` and ``chip_ab.py`` import anything of the JAX package
``bblean_tpu``.

The import check runs in a subprocess: ``tests/conftest.py`` imports jax
into the test process itself.  ``chip_smoke.py`` imports the port inside
its phases, so its imports are also read from its source.
"""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT_SOURCES = sorted((ROOT / "bblean_tpu_torch").rglob("*.py"))


def test_port_and_chip_smoke_import_no_jax() -> None:
    code = (
        "import sys\n"
        "import bblean_tpu_torch, bblean_tpu_torch.engine.batch\n"
        "import bblean_tpu_torch.engine.state_io, bblean_tpu_torch._build\n"
        "import bblean_tpu_torch.ops.tile_search, bblean_tpu_torch.fingerprints\n"
        "import chip_smoke, chip_profile, chip_ab\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'bblean_tpu' or m.startswith('bblean_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def _imported_modules(path: Path) -> list[str]:
    r"""Every module an ``import`` or ``from ... import`` in ``path`` names,
    at any depth (function bodies included)."""
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    return names


@pytest.mark.parametrize(
    "path",
    [ROOT / "chip_smoke.py", ROOT / "chip_profile.py", ROOT / "chip_ab.py", *PORT_SOURCES],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_source_imports_nothing_of_the_jax_package(path) -> None:
    bad = [
        m for m in _imported_modules(path)
        if m.split(".")[0] in ("jax", "jaxlib", "bblean_tpu")
    ]
    assert not bad, f"{path.name} imports {bad}"


def test_copied_host_helpers_equal_the_jax_package_ones(tmp_path) -> None:
    r"""``bblean_tpu_torch.fingerprints`` copies host helpers of
    ``bblean_tpu``; the copies give the same fingerprints, iSIM and
    multi-file gather."""
    from bblean_tpu import _np_similarity, fingerprints as jfp
    from bblean_tpu_torch import fingerprints as tfp

    seed = 12620509540149709235
    for kw in (dict(pack=True), dict(pack=False), dict(n_features=264)):
        np.testing.assert_array_equal(
            tfp.make_fake_fingerprints(500, seed=seed, **kw),
            jfp.make_fake_fingerprints(500, seed=seed, **kw),
        )
    fps = tfp.make_fake_fingerprints(300, seed=1, pack=False)
    for rows in (fps[:40], fps[:2], fps[:7] * 0):
        ls = rows.sum(0, dtype=np.int64)
        assert tfp.jt_isim_from_sum(ls, len(rows)) == _np_similarity.jt_isim_from_sum(
            ls, len(rows)
        )
    files, start = [], 0
    for i, n in enumerate((100, 0, 150, 50)):
        files.append(tmp_path / f"f{i}.npy")
        np.save(files[-1], np.packbits(fps[start : start + n], axis=-1))
        start += n
    idxs = [0, 5, 99, 100, 101, 249, 250, 299]
    np.testing.assert_array_equal(
        tfp._get_fingerprints_from_file_seq(files, idxs),
        jfp._get_fingerprints_from_file_seq(files, idxs),
    )
