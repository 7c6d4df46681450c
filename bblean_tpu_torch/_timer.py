r"""Named wall-clock timing segments, dumpable to ``timings.json``.

A copy of ``bblean_tpu/_timer.py`` (the port imports nothing of the JAX
package).
"""

from __future__ import annotations

import json
import time
import typing as tp
from pathlib import Path

__all__ = ["Timer"]


class Timer:
    r"""Collects named wall-clock segments."""

    def __init__(self) -> None:
        self._starts: dict[str, float] = {}
        self.timings: dict[str, float] = {}

    def init_timing(self, name: str) -> None:
        self._starts[name] = time.perf_counter()

    def end_timing(
        self, name: str, console: tp.Any = None, indent: bool = True
    ) -> float:
        elapsed = time.perf_counter() - self._starts.pop(name)
        self.timings[name] = elapsed
        if console is not None:
            pad = "    - " if indent else ""
            console.print(f"{pad}{name}: {elapsed:.2f} s")
        return elapsed

    def dump(self, path: Path | str) -> None:
        with open(path, "wt", encoding="utf-8") as f:
            json.dump(self.timings, f, indent=4)
