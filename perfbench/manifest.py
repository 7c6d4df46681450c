r"""``BENCHMARK.json``: loading, and finding each entry's files.

Every piece of a cell is found by its name: the configuration by its
``file``, the traffic mix at ``perfbench/traffic/<traffic>.json``, the loop
that drives it at ``perfbench/drivers/<driver>.py`` (the mix names its
driver) and each per-layer metric's reader at
``perfbench/metrics/<metric>.py``.  :func:`load` refuses a manifest whose
names a file could not be made from, whose per-layer metrics are read in a
cell that does not report the metric they move, or that names a missing
file, so a run fails before it starts.  The format's other rules
(counts, bounds, lengths, keys) are not checked here.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
import types
from pathlib import Path

__all__ = ["Manifest", "ManifestError", "load", "load_module"]

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


class ManifestError(ValueError):
    r"""``BENCHMARK.json`` or a file it names breaks a rule."""


def _need(ok: bool, what: str) -> None:
    if not ok:
        raise ManifestError(what)


def _name(name: object, what: str) -> None:
    _need(isinstance(name, str) and NAME.fullmatch(name) is not None, f"{what}: bad name {name!r}")


def load_module(path: Path) -> types.ModuleType:
    r"""Import a Python file by its path (a metric's file name holds dots)."""
    spec = importlib.util.spec_from_file_location(f"perfbench_file_{path.stem.replace('.', '_')}", path)
    if spec is None or spec.loader is None:
        raise ManifestError(f"cannot import {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Manifest:
    r"""A checked ``BENCHMARK.json`` and the files its names lead to."""

    def __init__(self, root: Path, data: dict) -> None:
        self.root, self.data = root, data
        self.configs = {c["name"]: c for c in data["configs"]}
        self.workloads = {w["name"]: w for w in data["workloads"]}
        self.end_to_end = {m["name"]: m for m in data["end_to_end"]}
        self.per_layer = {m["name"]: m for m in data["per_layer"]}

    def _file(self, rel: str) -> Path:
        path = self.root / rel
        _need(path.is_file(), f"{rel} is missing")
        return path

    def config(self, name: str) -> dict:
        return json.loads(self._file(self.configs[name]["file"]).read_text())

    def traffic(self, name: str) -> dict:
        return json.loads(self._file(f"perfbench/traffic/{name}.json").read_text())

    def driver(self, name: str) -> types.ModuleType:
        return load_module(self._file(f"perfbench/drivers/{name}.py"))

    def metric(self, name: str) -> types.ModuleType:
        return load_module(self._file(f"perfbench/metrics/{name}.py"))

    def reports(self, metric: dict, cell: str) -> bool:
        r"""Whether ``cell`` reports ``metric`` (no ``workloads`` key: every
        cell, for an end-to-end metric; every cell that reports the metric
        it moves, for a per-layer one)."""
        if "workloads" in metric:
            return cell in metric["workloads"]
        if "moves" in metric:
            return self.reports(self.end_to_end[metric["moves"]], cell)
        return True

    def end_to_end_of(self, cell: str) -> list[dict]:
        return [m for m in self.data["end_to_end"] if self.reports(m, cell)]

    def per_layer_of(self, cell: str) -> list[dict]:
        return [m for m in self.data["per_layer"] if self.reports(m, cell)]


def _check(data: dict) -> None:
    for c in data["configs"]:
        _name(c["name"], "config")
    for w in data["workloads"]:
        _name(w["name"], "workload")
        _name(w["traffic"], f"workload {w['name']} traffic")
    man = Manifest(Path("."), data)
    for m in data["end_to_end"] + data["per_layer"]:
        _name(m["name"], "metric")
        _need(isinstance(m["unit"], str) and UNIT.fullmatch(m["unit"]) is not None, f"metric {m['name']}: bad unit")
    for m in data["per_layer"]:
        _need(m["moves"] in man.end_to_end, f"metric {m['name']}: moves names no end-to-end metric")
        for cell in m.get("workloads", sorted(man.workloads)):
            _need(
                man.reports(man.end_to_end[m["moves"]], cell),
                f"metric {m['name']}: cell {cell} does not report {m['moves']}",
            )


def load(root: Path) -> Manifest:
    r"""The checked manifest at ``root/BENCHMARK.json``; every file that
    a name leads to must exist."""
    data = json.loads((root / "BENCHMARK.json").read_text())
    _check(data)
    man = Manifest(root, data)
    for c in data["configs"]:
        man.config(c["name"])
    for w in data["workloads"]:
        man.driver(man.traffic(w["traffic"])["driver"])
    for m in data["per_layer"]:
        man._file(f"perfbench/metrics/{m['name']}.py")
    return man


if __name__ == "__main__":
    _root = Path(sys.argv[1]) if len(sys.argv) > 1 else Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    load(_root)
    print("BENCHMARK.json: ok")
