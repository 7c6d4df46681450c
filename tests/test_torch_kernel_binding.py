r"""The binding of the hand-written CUDA kernels (``ops/_kernel.py``) and
the layering of ``ops/``.

Every wrapper sends CPU tensors to its plain version, launching nothing,
and tensors on any other device to its kernel, which refuses what is not
on one CUDA device; a kernel that does not build raises.  The shared
argument check is held here with stand-ins for CUDA tensors (a CPU tensor
that reports ``cuda:N``): the card's own cases are in
``tests/test_torch_cuda.py``.  No module under ``ops/`` imports the
engine, the sharded engine or the command line.
"""

import ast
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from bblean_tpu_torch import _build
from bblean_tpu_torch.engine import batch as tb
from bblean_tpu_torch.ops import (
    _kernel,
    commit_writes as cw,
    leader_election as le,
    prefix_commit as pc,
    refresh as rf,
    route,
    tile_search as ts,
)

ROOT = Path(__file__).resolve().parent.parent
OPS = sorted((ROOT / "bblean_tpu_torch" / "ops").glob("*.py"))
SEED = 20261024


def _route_args(twin: bool) -> tuple:
    rng = np.random.default_rng(SEED)
    rows = torch.from_numpy((rng.random((40, 100)) < 0.2).astype(np.int8))
    cent = torch.from_numpy((rng.random((64, 100)) < 0.2).astype(np.int8))
    pops, cpops = rows.sum(1, dtype=torch.int32), cent.sum(1, dtype=torch.int32)
    if twin:
        return rows, pops, cent, cpops, 33, 8
    return rows, pops, cent, cpops, 33, torch.from_numpy(rng.random(40) < 0.7), 8


def _search_args() -> tuple:
    rng = np.random.default_rng(SEED + 1)
    g, fc, f8, m = 3, 8, 16, 40
    t_pk = torch.from_numpy(rng.integers(0, 256, (g, fc, f8), dtype=np.uint8))
    t_pops = _popcount(t_pk)
    t_slot = torch.from_numpy(rng.integers(-1, 50, (g, fc)).astype(np.int32))
    row_pk = torch.from_numpy(rng.integers(0, 256, (m, f8), dtype=np.uint8))
    row_group = torch.from_numpy(rng.integers(0, g, m).astype(np.int32))
    pending = torch.from_numpy(rng.random(m) < 0.8)
    return row_pk, _popcount(row_pk), row_group, t_pk, t_pops, t_slot, pending


def _popcount(packed: torch.Tensor) -> torch.Tensor:
    bits = np.unpackbits(packed.numpy(), axis=-1)
    return torch.from_numpy(bits.sum(-1).astype(np.int32))


def _prefix_args() -> tuple:
    rng = np.random.default_rng(SEED + 2)
    row_ls, row_n, cand_ls, cand_n, accept, best = map(
        torch.from_numpy, chip_smoke.prefix_commit_case(rng, 64, 64, "mixed")
    )
    order, _grp, start = tb._group_ids_by_key(torch.where(accept, best, tb._BIG))
    seg = torch.cummax(torch.where(start, torch.arange(64, dtype=torch.int32), 0), 0).values.long()
    inc = accept[order]
    new_n, old_n, _s_n = tb._prefix_counts(inc, row_n[order], cand_n[order], seg)
    return ("tolerance-radius", row_ls, cand_ls, new_n, old_n, order, inc, seg)


def _election_args() -> tuple:
    case = chip_smoke.election_case(np.random.default_rng(SEED + 3), 64, 64, "t=0.3 groups")
    return chip_smoke.election_args(case, "cpu", "wide")


def _writes_args() -> tuple:
    case = chip_smoke.commit_writes_case(np.random.default_rng(SEED + 4), 64, 64, "t=0.3 runs")
    return chip_smoke.writes_args(case, "cpu")


def _refresh_args() -> tuple:
    case = chip_smoke.refresh_case(np.random.default_rng(SEED + 5), 64, 64, 256, "t=0.3 runs")
    return chip_smoke.refresh_args(case, "cpu")


# One case a wrapper: (module, public function, plain version, inputs)
WRAPPERS = {
    "route_groups": (route, "route_groups", "route_groups_plain", lambda: _route_args(False)),
    "best_group_sim": (route, "best_group_sim", "best_group_sim_plain", lambda: _route_args(True)),
    "tile_search_sorted": (ts, "tile_search_sorted", "search_tiles_plain", _search_args),
    "plan_items": (
        ts, "plan_items", "plan_items_plain",
        lambda: (torch.from_numpy(np.sort(np.random.default_rng(SEED).integers(0, 9, 300)).astype(np.int32)),),
    ),
    "prefix_commit": (pc, "prefix_commit_moments", "prefix_commit_moments_plain", _prefix_args),
    "leader_election": (le, "elect_leaders", "elect_leaders_plain", _election_args),
    "commit_writes": (cw, "commit_writes", "commit_writes_plain", _writes_args),
    "refresh": (rf, "refresh_touched", "refresh_touched_plain", _refresh_args),
}


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for a in x for t in _tensors(a)]
    return []


def _to(x, device: str):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, (tuple, list)):
        return type(x)(_to(a, device) for a in x)
    return x


def _counts() -> list[int]:
    return [getattr(m, n) for m, n in _kernel.counters]


@pytest.mark.parametrize("wrapper", list(WRAPPERS))
def test_wrapper_runs_the_plain_version_on_the_cpu(wrapper, monkeypatch) -> None:
    r"""CPU tensors take the plain version (equal outputs, and equal tables
    where it writes in place) and launch nothing; tensors off the CPU
    ("meta") go to the kernel, never to the plain version, and are refused
    there; a kernel that does not build raises, naming its source (no
    fallback)."""
    mod, public, plain, make = WRAPPERS[wrapper]
    got_args, ref_args = make(), make()
    before = _counts()
    got = getattr(mod, public)(*got_args)
    ref = getattr(mod, plain)(*ref_args)
    assert _counts() == before
    got_t, ref_t = _tensors((got, got_args)), _tensors((ref, ref_args))
    assert len(got_t) == len(ref_t) > 0
    assert all(torch.equal(a, b) for a, b in zip(got_t, ref_t))

    with pytest.raises(ValueError, match="one CUDA device"):
        getattr(mod, public)(*_to(make(), "meta"))

    def no_build(source):
        raise RuntimeError(f"nvcc failed to build {source}")

    monkeypatch.setattr(mod.kernel, "_lib", None)
    monkeypatch.setattr(_build, "load_kernel_library", no_build)
    with pytest.raises(RuntimeError, match=mod.kernel.source):
        mod.kernel.lib()


class _OnCard:
    r"""A CPU tensor that reports CUDA device ``index``: what
    :meth:`_kernel.Kernel.check` reads of a tensor (dtype, shape, device,
    contiguity), without a card."""

    def __init__(self, t: torch.Tensor, index: int = 0) -> None:
        self.t, self.device = t, torch.device("cuda", index)
        self.dtype, self.shape = t.dtype, t.shape

    def dim(self) -> int:
        return self.t.dim()

    def is_contiguous(self) -> bool:
        return self.t.is_contiguous()


KERNEL = _kernel.Kernel("test", "none.cu", {})


def _named(**over) -> dict:
    named = {
        "rows": (_OnCard(torch.zeros((4, 3), dtype=torch.int32)), torch.int32, (4, 3)),
        "pops": (_OnCard(torch.zeros(4, dtype=torch.int32)), torch.int32, (None,)),
        "flags": (_OnCard(torch.zeros(4, dtype=torch.bool)), torch.bool, (4,)),
    }
    named.update(over)
    return named


def test_check_returns_the_device_of_tensors_that_fit() -> None:
    r"""Tensors of their dtype and shape (a None size takes any), contiguous
    on one CUDA device: the check returns that device."""
    assert KERNEL.check(_named()) == torch.device("cuda", 0)
    five = _OnCard(torch.zeros(5, dtype=torch.int32))
    assert KERNEL.check(_named(pops=(five, torch.int32, (None,)))) == torch.device("cuda", 0)


@pytest.mark.parametrize(
    "where", ["first on the cpu", "later on the cpu", "another card"],
)
def test_check_refuses_another_device(where) -> None:
    cpu = torch.zeros(4, dtype=torch.bool)
    over = {
        "first on the cpu": {"rows": (torch.zeros((4, 3), dtype=torch.int32), torch.int32, (4, 3))},
        "later on the cpu": {"flags": (cpu, torch.bool, (4,))},
        "another card": {"flags": (_OnCard(cpu, 1), torch.bool, (4,))},
    }[where]
    with pytest.raises(ValueError, match=r"test kernel needs every tensor on one CUDA device; \w+ is on"):
        KERNEL.check(_named(**over))


@pytest.mark.parametrize(
    "entry,match",
    [
        ((torch.zeros(4, dtype=torch.int64), torch.int32, (None,)), "pops must be torch.int32"),
        ((torch.zeros((4, 1), dtype=torch.int32), torch.int32, (None,)), r"pops must be .* of shape \(\*\)"),
        ((torch.zeros(3, dtype=torch.int32), torch.int32, (4,)), r"pops must be .* of shape \(4\), got .* \(3,\)"),
    ],
    ids=["dtype", "rank", "size"],
)
def test_check_refuses_a_wrong_dtype_or_shape(entry, match) -> None:
    t, dtype, shape = entry
    with pytest.raises(ValueError, match=match):
        KERNEL.check(_named(pops=(_OnCard(t), dtype, shape)))


def test_check_refuses_a_tensor_that_is_not_contiguous() -> None:
    strided = _OnCard(torch.zeros((3, 4), dtype=torch.int32).t())
    with pytest.raises(ValueError, match="test kernel: rows must be contiguous"):
        KERNEL.check(_named(rows=(strided, torch.int32, (4, 3))))


def test_check_skips_none() -> None:
    r"""A None entry (an optional input left out) is not checked, and the
    device is the first tensor's."""
    named = _named(rows=(None, torch.int32, (4, 3)))
    assert KERNEL.check(named) == torch.device("cuda", 0)
    named["pops"] = (_OnCard(torch.zeros(4, dtype=torch.int32), 1), torch.int32, (4,))
    with pytest.raises(ValueError, match="flags is on cuda:0, pops on cuda:1"):
        KERNEL.check(named)


def test_library_declares_its_symbols_and_verifies_once(monkeypatch) -> None:
    r"""The library is loaded once a process: its symbols get their argument
    and return types from the table, and ``verify`` runs after the load."""
    import ctypes

    loads, seen = [], []
    fake = types.SimpleNamespace(bb_a=types.SimpleNamespace(), bb_b=types.SimpleNamespace())
    monkeypatch.setattr(_build, "load_kernel_library", lambda src: loads.append(src) or fake)
    kernel = _kernel.Kernel("fake", "fake.cu", {"bb_a": ("pipq", "i"), "bb_b": ("", "z")}, verify=seen.append)
    assert kernel.lib() is fake and kernel.lib() is fake
    assert loads == ["fake.cu"] and seen == [fake]
    assert fake.bb_a.argtypes == [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong]
    assert fake.bb_a.restype is ctypes.c_int
    assert fake.bb_b.argtypes == [] and fake.bb_b.restype is ctypes.c_size_t


def test_every_wrapper_names_its_launch_counters() -> None:
    r"""The counters that graph replays advance (``engine/graphs.py``) are
    every wrapper's, each once, named by the wrappers themselves."""
    named = [(m.__name__.rsplit(".", 1)[-1], n) for m, n in _kernel.counters]
    assert len(named) == len(set(named))
    assert set(named) == {
        ("route", "route_launches"), ("route", "best_sim_launches"),
        ("route", "wgmma_launches"), ("route", "generic_launches"),
        ("tile_search", "launches"), ("tile_search", "row_launches"),
        ("tile_search", "generic_launches"), ("tile_search", "plan_launches"),
        ("prefix_commit", "launches"), ("leader_election", "launches"),
        ("commit_writes", "launches"), ("refresh", "launches"),
    }
    _kernel.count_launches(route.__name__, "route_launches")
    assert len(_kernel.counters) == len(named)


def test_route_names_a_refused_tensor_map() -> None:
    r"""The route's own error codes (a tensor map that CUDA refused) keep
    their message; every other code is a CUDA error's."""
    assert route.kernel.error_text(route._ENCODE_ERROR + 1) == (
        "route kernel: TMA descriptor refused: CUresult 1"
    )
    assert route.kernel.error_text(700) is None


@pytest.mark.parametrize("path", OPS, ids=lambda p: p.name)
def test_ops_import_nothing_above_them(path) -> None:
    r"""The kernel layer imports neither the engine, the sharded engine nor
    the command line, at any depth of the module."""
    above = ("bblean_tpu_torch.engine", "bblean_tpu_torch.parallel", "bblean_tpu_torch.cli")
    bad = []
    for node in ast.walk(ast.parse(path.read_text())):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module] + [f"{node.module}.{a.name}" for a in node.names]
        bad += [n for n in names if any(n == a or n.startswith(a + ".") for a in above)]
    assert not bad, f"{path.name} imports {bad}"
