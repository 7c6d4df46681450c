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
        "import bblean_tpu_torch.engine.graphs\n"
        "import bblean_tpu_torch.ops.tile_search, bblean_tpu_torch.fingerprints\n"
        "import bblean_tpu_torch.ops.route, bblean_tpu_torch.ops.prefix_commit\n"
        "import bblean_tpu_torch.ops.leader_election, bblean_tpu_torch.ops.commit_writes\n"
        "import bblean_tpu_torch.ops.refresh\n"
        "import bblean_tpu_torch._timer, bblean_tpu_torch._config\n"
        "import bblean_tpu_torch._console, bblean_tpu_torch._memory\n"
        "import bblean_tpu_torch._device, bblean_tpu_torch.utils, bblean_tpu_torch.cli\n"
        "import bblean_tpu_torch.ops, bblean_tpu_torch.ops.popcount\n"
        "import bblean_tpu_torch.ops.tanimoto, bblean_tpu_torch.ops.kmeans\n"
        "import bblean_tpu_torch.ops.tsne\n"
        "import bblean_tpu_torch.parallel, bblean_tpu_torch.parallel.mesh\n"
        "import bblean_tpu_torch.parallel.sharded, bblean_tpu_torch._graft_entry\n"
        "import bblean_tpu_torch._np_similarity, bblean_tpu_torch.similarity\n"
        "import bblean_tpu_torch._merges, bblean_tpu_torch._native\n"
        "import bblean_tpu_torch.engine.exact, bblean_tpu_torch.engine.native\n"
        "import bblean_tpu_torch.tree, bblean_tpu_torch.metrics\n"
        "import bblean_tpu_torch.multiround\n"
        "import bblean_tpu_torch.smiles, bblean_tpu_torch.analysis, bblean_tpu_torch._pca\n"
        "import bblean_tpu_torch.plotting, bblean_tpu_torch.benchmarks\n"
        "import bblean_tpu_torch.benchmarks.scale_10m, bblean_tpu_torch.benchmarks.route_cost\n"
        "import bblean_tpu_torch.examples.quickstart, bblean_tpu_torch.examples.best_practices\n"
        "import bblean_tpu_torch.examples.dataset_splitting, bblean_tpu_torch.examples.multi_device\n"
        "from bblean_tpu_torch import BitBirch, set_merge\n"
        "import chip_smoke, chip_profile, chip_ab\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'bblean_tpu' or m.startswith('bblean_tpu.')\n"
        "             or m == 'sklearn' or m.startswith('sklearn.'))\n"
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
    [
        ROOT / "chip_smoke.py", ROOT / "chip_profile.py", ROOT / "chip_ab.py",
        *PORT_SOURCES,
    ],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_source_imports_nothing_of_the_jax_package(path) -> None:
    bad = [
        m for m in _imported_modules(path)
        if m.split(".")[0] in ("jax", "jaxlib", "bblean_tpu")
    ]
    assert not bad, f"{path.name} imports {bad}"


def test_cli_text_names_the_engines_that_are_ported(capsys) -> None:
    r"""The module's docstring and ``--engine``'s help say that every engine
    runs, the exact one (the default) on the host, and that ``multiround``
    is a command; no sentence says an engine is refused."""
    from bblean_tpu_torch import cli

    doc = " ".join(cli.__doc__.split())
    assert "``run --engine sharded``" in doc
    assert "default is ``--engine exact``" in doc and "``multiround``" in doc
    assert "refused" not in doc and "not yet ported" not in doc
    with pytest.raises(SystemExit):
        cli.main(["run", "--help"])
    text = " ".join(capsys.readouterr().out.split())
    assert "sharded: one batched forest per visible device" in text
    assert "exact: reference-identical labels on the host" in text
    assert "the exact engine runs on the host and ignores it" in text
    assert "only batch is ported" not in text and "not ported yet" not in text
    with pytest.raises(SystemExit):
        cli.main(["multiround", "--help"])
    assert "--num-midsection-rounds" in capsys.readouterr().out


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


def test_copied_host_modules_equal_the_jax_package_ones(tmp_path) -> None:
    r"""``utils``, ``_timer``, ``_config`` and the fingerprint-file helpers
    are copies: the same values, files and defaults as the originals."""
    import dataclasses

    from bblean_tpu import _config as jcfg, _timer as jtimer, fingerprints as jfp, utils as jutils
    from bblean_tpu_torch import _config as tcfg, _timer as ttimer, fingerprints as tfp, utils as tutils

    for nmax in (0, 1, 255, 256, 65_535, 65_536, 2**32 - 1, 2**32, 2**64 - 1):
        assert tutils.min_safe_uint(nmax) == jutils.min_safe_uint(nmax)
    with pytest.raises(ValueError):
        tutils.min_safe_uint(2**64)
    for n in (1, 3, 7, 10):
        assert list(tutils.batched(range(10), n)) == list(jutils.batched(range(10), n))
    with pytest.raises(ValueError):
        list(tutils.batched(range(3), 0))
    assert tutils._cpu_name() == jutils._cpu_name()
    assert tutils._num_avail_cpus() == jutils._num_avail_cpus()

    bits = tfp.make_fake_fingerprints(40, n_features=104, seed=3, pack=False)[:, :100]
    packed = tfp.pack_fingerprints(bits)
    np.testing.assert_array_equal(packed, jfp.pack_fingerprints(bits))
    for nf in (None, 100):
        np.testing.assert_array_equal(
            tfp.unpack_fingerprints(packed, nf), jfp.unpack_fingerprints(packed, nf)
        )
    files = []
    for i, n in enumerate((40, 0, 25)):
        files.append(tmp_path / f"f{i}.npy")
        np.save(files[-1], packed[:n])
        assert tfp._get_fps_file_num(files[-1]) == jfp._get_fps_file_num(files[-1]) == n
    seq_t, seq_j = tfp._FingerprintFileSequence(files), jfp._FingerprintFileSequence(files)
    assert seq_t.shape == seq_j.shape == (40, 13)
    np.testing.assert_array_equal(seq_t[[0, 39, 40, 64]], seq_j[[0, 39, 40, 64]])
    with pytest.raises(ValueError):
        tfp._FingerprintFileSequence([])

    assert dataclasses.asdict(tcfg.DEFAULTS) == dataclasses.asdict(jcfg.DEFAULTS)
    assert tcfg.TSNE_SEED == jcfg.TSNE_SEED
    dumps = []
    for mod in (ttimer, jtimer):
        timer = mod.Timer()
        timer.init_timing("a")
        timer.end_timing("a")
        timer.timings["a"] = 1.5
        path = tmp_path / f"{mod.__name__}.json"
        timer.dump(path)
        dumps.append(path.read_text())
    assert dumps[0] == dumps[1]


def test_host_memory_reads_agree_with_and_without_psutil(monkeypatch) -> None:
    r"""``system_mem_gib`` and the RSS monitor read ``/proc`` where psutil is
    not installed; both readings of this process agree with psutil's."""
    import os
    import sys

    import psutil

    from bblean_tpu_torch import _memory

    total, avail = _memory.system_mem_gib()
    rss = _memory._psutil_tree_rss(psutil, os.getpid())
    monkeypatch.setitem(sys.modules, "psutil", None)  # import psutil now fails
    total_proc, avail_proc = _memory.system_mem_gib()
    assert total_proc == pytest.approx(total, rel=1e-3) and total_proc > 0
    assert avail_proc == pytest.approx(avail, rel=0.2)
    rss_proc = _memory._proc_tree_rss(os.getpid())
    assert rss_proc == pytest.approx(rss, rel=0.2) and rss_proc > 0
    assert _memory._proc_tree_rss(2**22 + 12345) is None  # no such process
    assert _memory.device_memory_stats("cpu") is None


@pytest.mark.parametrize("with_psutil", [True, False])
def test_rss_monitor_writes_its_files(tmp_path, with_psutil) -> None:
    r"""The monitor's loop (run in a thread here, on a child process that
    ends) writes ``monitor-rss.csv`` and ``max-rss.txt`` and stops when the
    process it watches is gone."""
    import subprocess
    import sys
    import threading
    import unittest.mock

    from bblean_tpu_torch import _memory

    child = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(1.0)"])
    hide = {} if with_psutil else {"psutil": None}
    with unittest.mock.patch.dict(sys.modules, hide):
        watcher = threading.Thread(
            target=_memory._monitor_rss, args=(tmp_path, child.pid, 0.05), daemon=True
        )
        watcher.start()
        child.wait(timeout=30)
        watcher.join(timeout=30)
    assert not watcher.is_alive()
    lines = (tmp_path / "monitor-rss.csv").read_text().splitlines()
    assert lines[0] == "time_s,rss_gib" and len(lines) > 2
    assert (tmp_path / "max-rss.txt").read_text().endswith(" GiB\n")


def test_console_prints_plainly_without_rich(capsys) -> None:
    r"""Where rich is missing the console prints the same text without the
    style tags."""
    from bblean_tpu_torch import _console

    class Plain(_console._PlainConsole):
        print_config = _console.BBConsole.print_config
        print_banner = _console.BBConsole.print_banner

    console = Plain()
    console.print_banner()
    console.print_config({"threshold": 0.3})
    with console.status("[italic]working[/italic]", spinner="dots"):
        console.print("    - [green]Valid fingerprint file[/green]")
    out = capsys.readouterr().out
    assert "Config:" in out and "    - threshold: 0.3" in out
    assert "    - Valid fingerprint file" in out
    assert "[bold" not in out and "[/" not in out and "PyTorch + CUDA" in out
    silent = _console.get_console(silent=True)
    silent.print_banner()
    silent.print_config({"a": 1})
    silent.print_peak_hbm("cpu")
    silent.print_peak_mem(".")
    assert capsys.readouterr().out == ""
    assert isinstance(_console.get_console(), _console.BBConsole)
    _console.get_console().print_peak_hbm("cpu")  # no device, no line
    assert capsys.readouterr().out == ""


# Modules of the analysis side and the benchmarks, which must import on a
# machine without the optional packages of the JAX package's analysis side
NEW_MODULES = [
    "bblean_tpu_torch.analysis", "bblean_tpu_torch.plotting", "bblean_tpu_torch._pca",
    "bblean_tpu_torch.cli", "bblean_tpu_torch.smiles",
    "bblean_tpu_torch.benchmarks.scale_10m", "bblean_tpu_torch.benchmarks.route_cost",
]
BLOCKED = [
    "jax", "bblean_tpu", "matplotlib", "seaborn", "sklearn", "pandas", "click",
    "rich", "rdkit",
]


def test_new_modules_import_without_the_optional_packages() -> None:
    r"""With ``jax``, ``bblean_tpu``, matplotlib, seaborn, scikit-learn,
    pandas, click, rich and RDKit blocked (a finder first on
    ``sys.meta_path`` raises ``ImportError`` for each; a ``None`` entry in
    ``sys.modules`` would do the same, but scipy reads
    ``sys.modules["jax"]`` and fails on ``None``), the analysis side, the
    command line and both benchmark modules import, and the embeddings
    run."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        f"        if name.split('.')[0] in {BLOCKED!r}:\n"
        "            raise ImportError(f'{name} is blocked')\n"
        "sys.meta_path.insert(0, Block())\n"
        f"for mod in {NEW_MODULES!r}:\n"
        "    __import__(mod)\n"
        "import numpy as np\n"
        "from bblean_tpu_torch import plotting\n"
        "from bblean_tpu_torch.analysis import cluster_analysis\n"
        "from bblean_tpu_torch.fingerprints import make_fake_fingerprints, _HAS_RDKIT\n"
        "fps = make_fake_fingerprints(60, seed=1)\n"
        "ca = cluster_analysis([list(range(30)), list(range(30, 60))], fps=fps)\n"
        "assert plotting.pca_embedding(ca).shape == (60, 2)\n"
        "assert plotting.tsne_embedding(ca, n_iter=3, device='cpu').shape == (60, 2)\n"
        "assert not _HAS_RDKIT\n"
        "try:\n"
        "    plotting.summary_plot(ca)\n"
        "except ImportError as e:\n"
        "    assert 'matplotlib' in str(e)\n"
        "else:\n"
        "    raise AssertionError('drew without matplotlib')\n"
        f"assert not [m for m in sys.modules if m.split('.')[0] in {BLOCKED!r}]\n"
        "print('ok')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def _after_docstring(path: Path) -> str:
    r"""A module's source after its docstring."""
    src = path.read_text()
    return "\n".join(src.splitlines()[ast.parse(src).body[0].end_lineno :])


@pytest.mark.parametrize("name", ["smiles.py", "analysis.py"])
def test_copied_modules_equal_their_originals(name) -> None:
    r"""``smiles.py`` and ``analysis.py`` are copies: below the module
    docstring the same text as the JAX package's, apart from the package
    name."""
    port = _after_docstring(ROOT / "bblean_tpu_torch" / name)
    orig = _after_docstring(ROOT / "bblean_tpu" / name)
    assert port.replace("bblean_tpu_torch", "bblean_tpu") == orig


def test_copied_featurization_equals_the_original() -> None:
    r"""The SMILES half of ``fingerprints.py`` is a copy: each function and
    worker class has the JAX package's source, apart from the package
    name."""
    import inspect

    from bblean_tpu import fingerprints as jfp
    from bblean_tpu_torch import fingerprints as tfp

    for name in (
        "_require_rdkit", "_get_generator", "_get_sanitize_flags", "fps_from_smiles",
        "_FingerprintFileCreator", "_FingerprintArrayFiller",
    ):
        port = inspect.getsource(getattr(tfp, name)).replace("bblean_tpu_torch", "bblean_tpu")
        assert port == inspect.getsource(getattr(jfp, name)), name
    assert tfp._HAS_RDKIT == jfp._HAS_RDKIT


@pytest.mark.parametrize("module", ["scale_10m", "route_cost"])
def test_benchmarks_refuse_to_run_without_a_card(module) -> None:
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is available")
    proc = subprocess.run(
        [sys.executable, "-m", f"bblean_tpu_torch.benchmarks.{module}"], cwd=ROOT,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "no result" in proc.stderr


def test_help_lists_every_command_of_bb(capsys) -> None:
    r"""``bb-torch --help`` lists every command ``bb --help`` lists."""
    from bblean_tpu.cli import main as jax_main
    from bblean_tpu_torch import cli

    with pytest.raises(SystemExit) as exc:
        cli.main(["--help"])
    assert exc.value.code == 0
    text = capsys.readouterr().out
    listed = {line.split()[0] for line in text.splitlines() if line.startswith("    ") and line.split()}
    assert set(jax_main.commands) <= listed, set(jax_main.commands) - listed
    assert "--version" in text
