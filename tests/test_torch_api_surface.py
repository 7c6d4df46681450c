r"""The port's public surface against the JAX package's.

Every module of ``bblean_tpu`` (the package itself included) must have its
counterpart in ``bblean_tpu_torch`` under the same dotted name, holding
every public name of the JAX module: the names in its ``__all__`` and the
functions and classes it defines.  Every public method of such a class
must exist on the port's class, and every parameter name of a JAX
function, class or method must exist on the port's.  Every command of
``bb`` (click) must exist in ``bb-torch``'s argparse parser with each of
its option strings, its positional arguments and its choices.

What the port leaves out on purpose is in ``ALLOWLIST``, each entry with
its reason; an entry that no gap needs any more fails the last test.
"""

import argparse
import importlib
import inspect
import pkgutil

import click
import pytest

import bblean_tpu
import bblean_tpu_torch
from bblean_tpu.cli import main as bb_main
from bblean_tpu_torch.cli import _build_parser

# Gaps the port keeps on purpose, each with its reason
ALLOWLIST = {
    "module bblean_tpu._jax_cache": (
        "JAX's persistent compilation cache; the port compiles no programs "
        "(its kernels are built once by nvcc into csrc/build/)"
    ),
    "module bblean_tpu.ops.pallas_search": (
        "the Pallas per-row tile search; its counterpart is the per-row "
        "front end in ops/tile_search.py (tile_search_rows) over "
        "csrc/tile_search.cu"
    ),
    "module bblean_tpu.ops.pallas_search2": (
        "the Pallas sorted tile search and its plan; their counterparts are "
        "ops/tile_search.py (tile_search_sorted, tile_search_planned, "
        "sorted_search_plan) over csrc/tile_search.cu"
    ),
    "parameter use_pallas_search": (
        "chooses between JAX's XLA search and its Pallas kernel; the port "
        "has one search, the CUDA kernel on the card and its plain version "
        "on the CPU, chosen by the tensors' device"
    ),
    "parameter axis_name": (
        "names the axis of a jax.sharding.Mesh for shard_map's collectives; "
        "the port's mesh is a tuple of devices in one process with no "
        "named axis"
    ),
    "parameter bblean_tpu.cli.main args": (
        "click's group call takes *args; bb-torch's main takes argv"
    ),
    "parameter bblean_tpu.cli.main kwargs": (
        "click's group call takes **kwargs; bb-torch's main takes argv"
    ),
}

JAX_MODULES = [bblean_tpu.__name__] + [
    m.name for m in pkgutil.walk_packages(bblean_tpu.__path__, "bblean_tpu.")
]

# Modules of the port with no counterpart in the JAX package, each with its
# reason; a module missing here, or an entry naming no such module, fails
PORT_ONLY = {
    "_build": "builds csrc/ with nvcc and the host compiler at first use",
    "_device": "the port's device rule (CUDA unless the caller asks for the CPU)",
    "_graft_entry": "twin of the repository root's __graft_entry__.py",
    "_pca": "scikit-learn's PCA copied for the plots (no scikit-learn on the card's machine)",
    "benchmarks": "twin of the repository root's benchmarks/ folder",
    "benchmarks.route_cost": "twin of benchmarks/route_cost.py",
    "benchmarks.scale_10m": "twin of benchmarks/scale_10m.py",
    "engine.graphs": "the batch step's rounds and split passes as CUDA graphs (JAX compiles its step as one XLA program)",
    "engine.spans": "spans of the host driver's fit path, stamped on the profiler's clock (the JAX package records none)",
    "engine.state_io": "BatchState to and from numpy (JAX arrays convert themselves)",
    "examples": "twins of the repository root's examples/",
    "examples.best_practices": "twin of examples/best_practices.py",
    "examples.dataset_splitting": "twin of examples/dataset_splitting.py",
    "examples.multi_device": "twin of examples/multi_device.py",
    "examples.quickstart": "twin of examples/quickstart.py",
    "ops.tile_search": (
        "wrappers of csrc/tile_search.cu, the counterpart of ops/pallas_search.py "
        "and ops/pallas_search2.py"
    ),
    "ops.route": (
        "wrappers of csrc/route.cu and the plain versions: the route of "
        "engine/batch.py::_route_groups and the twin of "
        "parallel/sharded.py::_best_group_sim, XLA programs inside those modules"
    ),
    "ops.prefix_commit": (
        "wrapper of csrc/prefix_commit.cu and the plain version: the insert "
        "round's prefix-commit scans and merge-test sums, which JAX fuses "
        "inside the jitted step of engine/batch.py"
    ),
    "ops.leader_election": (
        "wrapper of csrc/leader_election.cu and the plain version: the insert "
        "round's leader election, which JAX fuses inside the jitted step of "
        "engine/batch.py"
    ),
    "ops.commit_writes": (
        "wrapper of csrc/commit_writes.cu and the plain version: the insert "
        "round's pool and tile writes, which JAX fuses inside the jitted step "
        "of engine/batch.py"
    ),
    "ops.refresh": (
        "wrapper of csrc/refresh.cu and the plain version: the batch step's "
        "refresh, engine/batch.py::_refresh_touched, which JAX fuses inside "
        "the jitted step"
    ),
    "ops._kernel": (
        "how the wrappers load, check, launch and count the CUDA kernels "
        "(JAX's Pallas kernels need no binding)"
    ),
    "ops.segments": (
        "the segment ops and drop-mode scatters that engine/batch.py and the "
        "kernels' plain versions share (JAX has jax.ops.segment_* and "
        ".at[].set(mode='drop'))"
    ),
}


def _port_name(name: str) -> str:
    return "bblean_tpu_torch" + name[len("bblean_tpu"):]


def _public_names(mod) -> set[str]:
    r"""``__all__`` and the public functions and classes ``mod`` defines."""
    names = set(getattr(mod, "__all__", ()))
    for n, v in vars(mod).items():
        if n.startswith("_") or not (inspect.isfunction(v) or inspect.isclass(v)):
            continue
        if v.__module__ == mod.__name__:
            names.add(n)
    return names


def _params(fn) -> set[str] | None:
    try:
        return set(inspect.signature(fn).parameters)
    except (TypeError, ValueError):
        return None


def _param_gaps(where: str, jax_fn, port_fn) -> set[str]:
    want, have = _params(jax_fn), _params(port_fn)
    if want is None:
        return set()
    if have is None:
        return {f"signature {where}"}
    gaps = set()
    for p in want - have:
        key = f"parameter {where} {p}"
        gaps.add(f"parameter {p}" if f"parameter {p}" in ALLOWLIST else key)
    return gaps


def _class_gaps(where: str, jax_cls, port_cls) -> set[str]:
    gaps = set()
    for m, v in vars(jax_cls).items():
        if m.startswith("_"):
            continue
        if not hasattr(port_cls, m):
            gaps.add(f"method {where}.{m}")
            continue
        fn = v.__func__ if isinstance(v, (classmethod, staticmethod)) else v
        if inspect.isfunction(fn):
            port_fn = getattr(port_cls, m)
            gaps |= _param_gaps(f"{where}.{m}", fn, getattr(port_fn, "__func__", port_fn))
    return gaps


def _module_gaps(name: str) -> set[str]:
    r"""What of JAX module ``name`` the port lacks, as ALLOWLIST-style keys."""
    jax_mod = importlib.import_module(name)
    try:
        port_mod = importlib.import_module(_port_name(name))
    except ModuleNotFoundError:
        return {f"module {name}"}
    gaps = set()
    for n in sorted(_public_names(jax_mod)):
        where = f"{name}.{n}"
        if not hasattr(port_mod, n):
            gaps.add(f"name {where}")
            continue
        jv, pv = getattr(jax_mod, n), getattr(port_mod, n)
        if inspect.isclass(jv):
            gaps |= _class_gaps(where, jv, pv)
        if callable(jv):
            gaps |= _param_gaps(where, jv, pv)
    return gaps


@pytest.mark.parametrize("name", JAX_MODULES)
def test_module_has_its_counterpart(name: str) -> None:
    assert _module_gaps(name) - set(ALLOWLIST) == set()


def test_every_allowlist_entry_is_still_needed() -> None:
    found = set().union(*(_module_gaps(n) for n in JAX_MODULES))
    assert set(ALLOWLIST) - found == set()


def test_version_and_engine_exports() -> None:
    from bblean_tpu_torch.engine import ExactTree
    from bblean_tpu_torch.engine.exact import ExactTree as defined

    assert ExactTree is defined
    assert bblean_tpu_torch.__version__ == bblean_tpu.__version__
    assert "__version__" in bblean_tpu_torch.__all__


def _port_commands() -> dict[str, argparse.ArgumentParser]:
    parser = _build_parser()
    sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return {"": parser, **sub.choices}


def _command_gaps(name: str, cmd: click.Command, parser) -> set[str]:
    actions = parser._option_string_actions
    gaps = set()
    for p in cmd.params:
        if isinstance(p, click.Argument):
            continue
        for opt in p.opts + p.secondary_opts:
            if opt not in actions:
                gaps.add(f"option bb {name} {opt}")
            elif isinstance(p.type, click.Choice):
                have = set(actions[opt].choices or ())
                if not set(p.type.choices) <= have:
                    gaps.add(f"choices bb {name} {opt}")
    n_args = sum(isinstance(p, click.Argument) for p in cmd.params)
    if n_args > sum(not a.option_strings for a in parser._actions):
        gaps.add(f"arguments bb {name}")
    return gaps


@pytest.mark.parametrize("name", ["", *bb_main.commands])
def test_bb_command_has_its_counterpart(name: str) -> None:
    r"""``name`` "" is the group itself (``--version``)."""
    ports = _port_commands()
    assert name in ports, f"bb-torch has no command {name}"
    cmd = bb_main if name == "" else bb_main.commands[name]
    assert _command_gaps(name, cmd, ports[name]) == set()


def test_port_only_modules_are_listed() -> None:
    r"""Every module of the port without a JAX counterpart has its reason
    in ``PORT_ONLY``, and every entry there is such a module."""
    jax = {name[len("bblean_tpu."):] for name in JAX_MODULES[1:]}
    port = {
        m.name[len("bblean_tpu_torch."):]
        for m in pkgutil.walk_packages(bblean_tpu_torch.__path__, "bblean_tpu_torch.")
    }
    assert port - jax == set(PORT_ONLY)
