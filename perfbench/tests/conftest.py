r"""Fixtures of the benchmark's CPU tests: a copy of the benchmark whose
cells are cut to a size the CPU fits in seconds."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# Rows, batch and share of rows merged of each cell here: at t = 0.3 the
# bfloat16 control shows at 16,384 rows (at 8,192 not on every seed); t =
# 0.65 shows at 8,192.  The share is the port's on the CPU at these sizes
# on SEED (a few hundred merges at t = 0.65, so it swings from seed to seed
# by far more than at the cells' sizes)
SEED = 2**31 + 101
TINY = {
    "lib1m-t030": (16384, 512, 0.555419921875),
    "lib10m-t065": (8192, 512, 0.0240478515625),
}


def copy_benchmark(dest: Path) -> Path:
    r"""``BENCHMARK.json`` and ``perfbench/`` (without its tests) under
    ``dest``."""
    shutil.copy(ROOT / "BENCHMARK.json", dest)
    shutil.copytree(
        ROOT / "perfbench", dest / "perfbench",
        ignore=shutil.ignore_patterns("__pycache__", "tests"),
    )
    return dest


@pytest.fixture
def tiny_root(tmp_path: Path) -> Path:
    r"""A copy of the benchmark with every configuration cut to ``TINY``."""
    root = copy_benchmark(tmp_path)
    for name, (rows, batch, share) in TINY.items():
        path = root / "perfbench" / "configs" / f"{name}.json"
        cfg = json.loads(path.read_text())
        cfg["n_rows"], cfg["merge_share"] = rows, share
        cfg["batch_tree"].update(batch_size=batch, initial_capacity=rows + batch + 1)
        path.write_text(json.dumps(cfg))
    path = root / "perfbench" / "traffic" / "library-fits.json"
    traffic = json.loads(path.read_text())
    traffic["library"]["chunk_rows"] = 4096
    traffic["warm_prefix_rows"] = 2048
    path.write_text(json.dumps(traffic))
    return root
