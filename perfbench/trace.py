r"""Reduction of a ``torch.profiler`` trace to what the metrics read.

:func:`events` turns a profiler's results into two plain lists: device
events ``(kind, name, start_ns, end_ns)`` with ``kind`` one of ``kernel``,
``memcpy``, ``memset``, and host events ``(name, start_ns, end_ns)`` (CPU
ops, ``record_function`` ranges, CUDA runtime and driver calls).  The rest
is arithmetic on those lists, kept apart so that tests can feed it a
synthetic trace:

- :func:`busy_ns`: the length of the union of the device intervals, so
  that overlapping work on several streams counts once;
- :func:`sums_by_name`: device time per name;
- :func:`kernel_ns`: device time of the kernels whose function name is in
  a list (:func:`kernel_matches`), from :func:`sums_by_name` of the
  kernels (a fit launches a few hundred kernel names and millions of
  kernels);
- :func:`idle_by_host`: the device's idle gaps inside a window, each
  labelled with the innermost host event open at its midpoint, summed by
  label.
"""

from __future__ import annotations

import bisect
import heapq
import re
from collections import defaultdict

__all__ = [
    "DeviceEvent", "HostEvent", "events", "busy_ns", "sums_by_name", "kernel_matches",
    "kernel_ns", "idle_by_host", "short_name", "top",
]

DeviceEvent = tuple[str, str, int, int]
HostEvent = tuple[str, int, int]

# What each kind of event is here (:func:`_kind_of`)
_DEVICE_KINDS = {"kernel": "kernel", "gpu_memcpy": "memcpy", "gpu_memset": "memset"}
# Label of an idle gap during which no host event was open (the host was
# running Python between calls)
NO_HOST_EVENT = "host python (no op open)"


def events(prof) -> tuple[list[DeviceEvent], list[HostEvent]]:
    r"""Device and host events of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    device: list[DeviceEvent] = []
    host: list[HostEvent] = []
    for e in prof.profiler.kineto_results.events():
        kind = _kind_of(e, DeviceType.CPU)
        if kind in _DEVICE_KINDS:
            device.append((_DEVICE_KINDS[kind], e.name(), e.start_ns(), e.end_ns()))
        elif kind == "cpu_op":
            host.append((e.name(), e.start_ns(), e.end_ns()))
    return device, host


def _kind_of(e, cpu) -> str:
    r"""What an event is, by its device, its name and its annotation flag
    (the profiler's events carry no activity type in torch 2.11): host
    events (CPU ops, ``record_function`` ranges, CUDA runtime and driver
    calls) are ``cpu_op``.  The profiler's own bookkeeping (device index
    -1 on the host), the device's copy of a ``record_function`` range and
    unnamed device records are none of the kinds read here."""
    name = e.name()
    if e.device_type() == cpu:
        return "overhead" if e.device_index() < 0 else "cpu_op"
    if e.is_user_annotation() or not name:
        return "gpu_user_annotation"
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    return "gpu_memset" if name.startswith("Memset") else "kernel"


def _merged(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    out: list[tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def busy_ns(device: list[DeviceEvent]) -> int:
    r"""Nanoseconds in which at least one device event ran."""
    return sum(e - s for s, e in _merged([(s, e) for _k, _n, s, e in device]))


def sums_by_name(device: list[DeviceEvent]) -> dict[str, int]:
    out: dict[str, int] = defaultdict(int)
    for _k, name, s, e in device:
        out[name] += e - s
    return dict(out)


def kernel_matches(name: str, kernels: tuple[str, ...]) -> bool:
    r"""Whether a kernel's (demangled) name is a call of one of the
    functions ``kernels``: ``void route_kernel(Params)`` matches
    ``route_kernel`` and not ``route``."""
    return any(re.search(rf"(?<![A-Za-z0-9_]){re.escape(k)}(?![A-Za-z0-9_])", name) for k in kernels)


def kernel_ns(
    kernel_sums: dict[str, int], kernels: tuple[str, ...], *, invert: bool = False
) -> int | None:
    r"""Device time of the kernels named in ``kernels`` (``invert``: of
    every kernel not named there), from the device time per kernel name;
    None where no kernel matches."""
    hits = [ns for name, ns in kernel_sums.items() if kernel_matches(name, kernels) != invert]
    return sum(hits) if hits else None


def idle_by_host(
    device: list[DeviceEvent], host: list[HostEvent], lo: int, hi: int
) -> dict[str, int]:
    r"""Idle nanoseconds of the device inside ``[lo, hi]``, by the host
    event open at each gap's midpoint (the one that started last, i.e. the
    innermost), :data:`NO_HOST_EVENT` where none is."""
    gaps: list[tuple[int, int]] = []
    t = lo
    for s, e in _merged([(max(s, lo), min(e, hi)) for _k, _n, s, e in device if e > lo and s < hi]):
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if t < hi:
        gaps.append((t, hi))
    hs = sorted(host, key=lambda h: h[1])
    starts = [h[1] for h in hs]
    open_: list[tuple[int, int, str]] = []  # (-start, end, name): latest start on top
    pushed = 0
    out: dict[str, int] = defaultdict(int)
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        upto = bisect.bisect_right(starts, mid)
        for name, s, e in hs[pushed:upto]:
            heapq.heappush(open_, (-s, e, name))
        pushed = max(pushed, upto)
        # A closed event on top is closed for every later midpoint too
        while open_ and open_[0][1] < mid:
            heapq.heappop(open_)
        out[open_[0][2] if open_ else NO_HOST_EVENT] += g1 - g0
    return dict(out)


def short_name(name: str, width: int = 120) -> str:
    r"""A kernel's name without its parameter list, at most ``width`` long."""
    name = name.replace("(anonymous namespace)::", "")
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            name = name[:i]
            break
    return name.removeprefix("void ").strip()[:width]


def top(ns_by_name: dict[str, int], k: int = 10, *, shorten: bool = True) -> list[list]:
    r"""The ``k`` largest entries as ``[name, seconds]``, largest first;
    with ``shorten``, kernel names without their parameters (names that
    shorten alike are summed)."""
    merged: dict[str, int] = defaultdict(int)
    for name, ns in ns_by_name.items():
        merged[short_name(name) if shorten else name] += ns
    ranked = sorted(merged.items(), key=lambda kv: -kv[1])[:k]
    return [[name, ns / 1e9] for name, ns in ranked]
