r"""A profile's device time and idle gaps laid over the program's own spans
(``bblean_tpu_torch/engine/spans.py``), and the host and device times by
layer that the spans give.

The spans are stamped on the clock of the profiler's host events, so the
two can be laid over each other:

- :func:`launches` links each device event of a profile to the host call
  (CUDA runtime or driver) that launched it, through the correlation id
  they share, and :func:`link` is the arithmetic of that: every kernel of
  a replayed CUDA graph shares its ``cudaGraphLaunch``'s id;
- :func:`device_by_span` gives each device event to the innermost span
  open when its launch call started, and :func:`idle_by_span` each idle
  gap of the device to the innermost span open at its midpoint (as
  ``trace.idle_by_host`` does with the profiler's host events);
- :func:`host_ms` splits one fit's ``fit`` span into the host's time in
  device-to-host reads, graph launches, programs built inside the fit,
  staging, and the rest (Python and eager torch dispatch).

A span is a tuple ``(name, id, parent, start_ns, end_ns, root, program)``
as the port records it; nothing here imports the port.  Spans of one host
thread nest, so the innermost span open at a time is the one that started
last among those still open.
"""

from __future__ import annotations

import heapq
import typing as tp
from collections import defaultdict

from perfbench import trace

__all__ = [
    "Launched", "launches", "link", "innermost", "label", "device_by_span",
    "idle_by_span", "host_ms", "NO_SPAN", "UNLINKED",
]

# (kind, name, start_ns, end_ns, launch_ns): a device event and the start
# of the host call that launched it (None where none was found)
Launched = tuple[str, str, int, int, "int | None"]

# Labels of device time or idle time that no span owns: launched (or idle)
# while no span was open, or launched by a call the profile did not hold
NO_SPAN = "(no span open)"
UNLINKED = "(launch not found)"


# A span record with the fields named above
_Span = tp.Any


def launches(prof) -> list[Launched]:
    r"""The device events of a finished ``torch.profiler.profile``, each
    with the start of the CUDA runtime or driver call that launched it."""
    from torch.autograd import DeviceType

    device, calls = [], []
    for e in prof.profiler.kineto_results.events():
        kind = trace._kind_of(e, DeviceType.CPU)
        if kind in trace._DEVICE_KINDS:
            device.append(
                (trace._DEVICE_KINDS[kind], e.name(), e.start_ns(), e.end_ns(), e.correlation_id())
            )
        elif kind == "cpu_op" and e.name().startswith("cu"):
            calls.append((e.name(), e.start_ns(), e.end_ns(), e.correlation_id()))
    return link(device, calls)


def link(
    device: list[tuple[str, str, int, int, int]], calls: list[tuple[str, int, int, int]]
) -> list[Launched]:
    r"""Device events ``(kind, name, start, end, correlation)`` with the
    start of the host call ``(name, start, end, correlation)`` of the same
    correlation id in place of the id (None where no call has it, or the
    id is 0: the profiler's own records)."""
    start = {c: s for _n, s, _e, c in calls if c}
    return [(k, n, s, e, start.get(c) if c else None) for k, n, s, e, c in device]


def innermost(spans: tp.Sequence[_Span], times: tp.Sequence[int]) -> list[_Span | None]:
    r"""For each of ``times``, the innermost span open then (None where no
    span is), in the order of ``times``."""
    order = sorted(range(len(times)), key=times.__getitem__)
    by_start = sorted(spans, key=lambda s: (s.start_ns, -s.end_ns))
    out: list[_Span | None] = [None] * len(times)
    open_: list[tuple[int, int, int]] = []  # (-start, end, index in by_start)
    pushed = 0
    for i in order:
        t = times[i]
        while pushed < len(by_start) and by_start[pushed].start_ns <= t:
            s = by_start[pushed]
            heapq.heappush(open_, (-s.start_ns, s.end_ns, pushed))
            pushed += 1
        # A closed span on top is closed for every later time too
        while open_ and open_[0][1] < t:
            heapq.heappop(open_)
        out[i] = by_start[open_[0][2]] if open_ else None
    return out


def label(span: _Span) -> str:
    r"""A span's name, with its program's for a ``program.*`` span."""
    return f"{span.name}({span.program})" if span.program else span.name


def _in_program(spans: tp.Sequence[_Span]) -> dict[int, bool]:
    r"""Whether each span is a ``program.*`` span or lies inside one."""
    by_id = {s.id: s for s in spans}
    out: dict[int, bool] = {}

    def walk(s: _Span) -> bool:
        if s.id not in out:
            parent = by_id.get(s.parent)
            out[s.id] = s.name.startswith("program.") or (parent is not None and walk(parent))
        return out[s.id]

    for s in spans:
        walk(s)
    return out


def device_by_span(
    device: list[Launched], spans: tp.Sequence[_Span], lo: int, hi: int
) -> dict[str, tp.Any]:
    r"""Device time of the events inside ``[lo, hi]`` (clipped to it), by
    the innermost span open when each event's launch call started.

    Returns ``by_span`` (ns by :func:`label`, :data:`NO_SPAN` and
    :data:`UNLINKED` included), ``program_ns`` (launched inside a
    ``program.*`` span: the rounds and split passes), ``eager_ns``
    (launched inside any other span), ``unattributed_ns``,
    ``unattributed`` (ns by event name, for what no span owns), ``total_ns``
    and ``busy_ns`` (the union of the intervals)."""
    inside = [
        (k, n, max(s, lo), min(e, hi), t) for k, n, s, e, t in device if e > lo and s < hi
    ]
    linked = [ev for ev in inside if ev[4] is not None]
    owners = innermost(spans, [ev[4] for ev in linked])
    in_program = _in_program(spans)
    by_span: dict[str, int] = defaultdict(int)
    unattributed: dict[str, int] = defaultdict(int)
    program = eager = 0
    for (_k, name, s, e, _t), owner in zip(linked, owners):
        if owner is None:
            by_span[NO_SPAN] += e - s
            unattributed[name] += e - s
        elif in_program[owner.id]:
            by_span[label(owner)] += e - s
            program += e - s
        else:
            by_span[label(owner)] += e - s
            eager += e - s
    for _k, name, s, e, t in inside:
        if t is None:
            by_span[UNLINKED] += e - s
            unattributed[name] += e - s
    total = sum(e - s for _k, _n, s, e, _t in inside)
    return {
        "by_span": dict(by_span), "program_ns": program, "eager_ns": eager,
        "unattributed_ns": total - program - eager, "unattributed": dict(unattributed),
        "total_ns": total, "busy_ns": trace.busy_ns([ev[:4] for ev in inside]),
    }


def idle_by_span(
    device: list[Launched], spans: tp.Sequence[_Span], lo: int, hi: int
) -> dict[str, int]:
    r"""Idle nanoseconds of the device inside ``[lo, hi]``, by the innermost
    span open at each gap's midpoint (:data:`NO_SPAN` where none is)."""
    gaps: list[tuple[int, int]] = []
    t = lo
    inside = [(max(s, lo), min(e, hi)) for _k, _n, s, e, _t in device if e > lo and s < hi]
    for s, e in trace._merged(inside):
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if t < hi:
        gaps.append((t, hi))
    owners = innermost(spans, [(g0 + g1) // 2 for g0, g1 in gaps])
    out: dict[str, int] = defaultdict(int)
    for (g0, g1), owner in zip(gaps, owners):
        out[NO_SPAN if owner is None else label(owner)] += g1 - g0
    return dict(out)


# The host metrics' parts of a ``fit`` span, by the spans they sum
HOST_PARTS = {
    "sync": ("sync",),
    "replay": ("program.replay",),
    "capture": ("program.warmup", "program.capture"),
}


def host_ms(spans: tp.Sequence[_Span], root: int) -> dict[str, float]:
    r"""Host milliseconds of the fit whose ``fit`` span has id ``root``:
    ``sync`` (device-to-host reads), ``replay`` (graph launches),
    ``capture`` (programs dispatched or captured inside the fit),
    ``staging`` (self time of ``stage_chunk``), and ``dispatch``, the
    ``fit`` span less those four.  The five add up to ``fit``.  The four
    spans never nest in one another (a program reads nothing on the host,
    a read opens nothing), so none is counted twice."""
    mine = [s for s in spans if s.root == root]
    (fit,) = [s for s in mine if s.id == root]
    out = {
        part: sum(s.end_ns - s.start_ns for s in mine if s.name in names) / 1e6
        for part, names in HOST_PARTS.items()
    }
    child_ns: dict[int, int] = defaultdict(int)
    for s in mine:
        child_ns[s.parent] += s.end_ns - s.start_ns
    out["staging"] = sum(
        s.end_ns - s.start_ns - child_ns[s.id] for s in mine if s.name == "stage_chunk"
    ) / 1e6
    out["fit"] = (fit.end_ns - fit.start_ns) / 1e6
    out["dispatch"] = out["fit"] - sum(out[p] for p in (*HOST_PARTS, "staging"))
    return out
