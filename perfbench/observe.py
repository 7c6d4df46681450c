r"""What a run hands the per-layer metrics' readers, and helpers for them.

A reader is ``perfbench/metrics/<metric>.py``; it defines
``read(obs: Observation) -> float | None`` and may declare
``COUNTERS``, the program's integer counters it reads (``"module:name"``;
the run takes each one's change over the window), and ``KERNELS``, the
functions of a hand-written kernel whose device time it reports (no other
reader then counts them as torch ops).  A reader that finds nothing to
read returns None, and the run leaves its metric out.
"""

from __future__ import annotations

import dataclasses
import importlib
import typing as tp

from perfbench import trace

__all__ = ["Observation", "read_counters", "kernel_reader", "per_mrow"]


@dataclasses.dataclass
class Observation:
    rows: int  # rows fitted in the window
    deltas: dict[str, int]  # each declared counter's change over the window
    traced_rows: int = 0  # rows fitted under the profiler
    traced_ns: int = 0  # wall of the profiled fit
    untraced_ns: int = 0  # median wall of the window's unprofiled fits
    device: list[trace.DeviceEvent] | None = None  # its device events
    kernel_sums: dict[str, int] = dataclasses.field(default_factory=dict)  # their kernels' ns by name
    claimed: tuple[str, ...] = ()  # every hand-kernel reader's KERNELS


def read_counters(names: tp.Iterable[str]) -> dict[str, int]:
    r"""The current value of each ``"module:name"`` counter."""
    out = {}
    for ref in names:
        mod, attr = ref.split(":")
        out[ref] = int(getattr(importlib.import_module(mod), attr))
    return out


def per_mrow(value: float, rows: int) -> float | None:
    return value / (rows / 1e6) if rows else None


def kernel_reader(kernels: tuple[str, ...]) -> tp.Callable[[Observation], float | None]:
    r"""``read`` of a hand kernel: device ms per million rows fitted under
    the profiler, None where the trace holds none of ``kernels``."""

    def read(obs: Observation) -> float | None:
        ns = trace.kernel_ns(obs.kernel_sums, kernels)
        return None if ns is None else per_mrow(ns / 1e6, obs.traced_rows)

    return read
