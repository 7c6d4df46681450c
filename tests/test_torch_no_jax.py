r"""The PyTorch port imports no JAX, directly or through ``bblean_tpu``.

Runs in a subprocess: ``tests/conftest.py`` imports jax into the test
process itself.
"""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def test_port_and_chip_smoke_import_no_jax() -> None:
    code = (
        "import sys\n"
        "import bblean_tpu_torch, bblean_tpu_torch.engine.batch\n"
        "import bblean_tpu_torch.engine.state_io, bblean_tpu_torch._build\n"
        "import bblean_tpu_torch.ops.tile_search\n"
        "import chip_smoke\n"
        "import bblean_tpu.fingerprints, bblean_tpu._np_similarity\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
