r"""The batch step's device programs as CUDA graphs: each insert round and
each split pass is captured once per key and replayed after that.

The JAX engine runs a batch step as one compiled XLA program: its insert
rounds loop on the device (``lax.while_loop``) and the split pass is part
of the program.  Dispatched one by one from Python, a round of the port is
several hundred small torch ops and two kernel launches, and the host sets
the pace.  On CUDA the counterpart of a compiled program is a CUDA graph:
the same ops in the same order, captured once and replayed with one launch.

A *program* is a function ``fn(tables, bufs) -> outputs``:

- ``tables`` are the state's tables, which the program updates in place;
- ``bufs`` (:class:`Buffers`) are its static inputs, which the caller fills
  before each run (the step's rows, the carried round state, the counters);
- ``outputs`` is a tuple of new tensors, which the caller must read (copy
  where it needs them) before any program runs again: on the card they are
  the capture's own tensors, overwritten by the next replay.

:func:`run` keys a program on its name and static parameters and on the
address, shape and dtype of every table and buffer it reads, so a table
that is replaced (a growth, a load, a transfer) gives a new key.  The first
use of a key runs ``fn`` dispatched: the warm-up, which also does that
run's work.  The second captures it and replays it; later uses replay.
Captures and warm-ups run on one side stream per device (the stream the
capture's lazy state, such as cuBLAS's workspace, belongs to), and every
capture of a device shares one graph memory pool: replays never overlap,
and the callers read outputs before the next replay.  A program is dropped,
with its graph, as soon as one of its tables is freed.

While spans are recorded (``engine/spans.py``), each run is a
``program.warmup``, ``program.capture`` or ``program.replay`` span named
after the program (a capture's replay is a span of its own).

A failed capture or replay raises; there is no fallback to dispatch.  On
the CPU the same runner calls ``fn`` at every use, through the same
buffers, so the CPU tests hold the buffer handling.

The kernel wrappers count launches at dispatch; a capture launches nothing
and a replay launches without Python.  So each program records, at
capture, how much each launch counter the wrappers name
(``ops/_kernel.py::counters``) rose, takes the capture's own increments
back, and adds the record at each replay.
"""

from __future__ import annotations

import typing as tp
import weakref

import torch

from bblean_tpu_torch.engine import spans
from bblean_tpu_torch.ops._kernel import counters as _counters

__all__ = [
    "Buffers", "Program", "buffers", "run", "observers",
    "captures", "replays", "warmups",
]

# Programs captured, replayed, and run dispatched at their key's first use
captures = 0
replays = 0
warmups = 0

# Callables ``fn(program, stage)`` called before ("before") and after
# ("after") every replay, for diagnostics that hold replays to dispatch
observers: list[tp.Callable[["Program", str], None]] = []

# The program being captured, else None (a wrapper called inside a capture
# can keep records in its ``notes``)
capturing: "Program | None" = None

_programs: dict[tuple, "Program"] = {}
_buffer_sets: "weakref.WeakValueDictionary[tuple, Buffers]" = weakref.WeakValueDictionary()
_streams: dict[torch.device, torch.cuda.Stream] = {}
_pools: "weakref.WeakValueDictionary[torch.device, _Pool]" = weakref.WeakValueDictionary()

Fn = tp.Callable[[tuple, "Buffers"], tuple]


class Buffers(dict):
    r"""A program's static inputs by name (tensors allocated outside any
    graph pool); one set is shared by every program keyed on it."""


class _Pool:
    r"""A device's graph memory pool, held by every program captured into
    it.  A pool whose graphs are all gone cannot take another capture, so
    once no program holds it the next capture opens a new one."""

    def __init__(self, device: torch.device) -> None:
        with torch.cuda.device(device):
            self.handle = torch.cuda.graph_pool_handle()


def _pool(device: torch.device) -> _Pool:
    pool = _pools.get(device)
    if pool is None:
        pool = _pools[device] = _Pool(device)
    return pool


def buffers(tag: tp.Hashable, device: torch.device, specs: dict) -> Buffers:
    r"""The static buffers ``{name: (shape, dtype)}`` of ``tag`` on
    ``device``, zero-filled when made; alive while a program (or a caller)
    holds them."""
    key = (tag, device) + tuple((k, tuple(s), dt) for k, (s, dt) in specs.items())
    bufs = _buffer_sets.get(key)
    if bufs is None:
        bufs = Buffers(
            (k, torch.zeros(s, dtype=dt, device=device)) for k, (s, dt) in specs.items()
        )
        _buffer_sets[key] = bufs
    return bufs


def _ident(t: torch.Tensor) -> tuple:
    return (t.data_ptr(), tuple(t.shape), t.dtype)


class Program:
    r"""One keyed program: its function, its buffers, weak references to
    its tables, and once captured on the card its graph, the capture's
    outputs and the launches it makes per replay."""

    def __init__(self, key: tuple, fn: Fn, tables: tuple, bufs: Buffers) -> None:
        self.key, self.fn, self.bufs = key, fn, bufs
        self.device = tables[0].device
        self._tables = tuple(weakref.ref(t) for t in tables)
        self._finalizers = [weakref.finalize(t, _drop, key) for t in tables]
        self.captured = False
        self.graph: torch.cuda.CUDAGraph | None = None
        self.pool: _Pool | None = None
        self.outputs: tuple = ()
        self.launches: dict[tuple, int] = {}
        self.notes: dict = {}  # observers' records of the capture, by observer

    def tables(self) -> tuple:
        r"""The tables (all alive while the program is cached)."""
        return tuple(r() for r in self._tables)


def _drop(key: tuple) -> None:
    prog = _programs.pop(key, None)
    if prog is not None:
        for f in prog._finalizers:
            f.detach()


def _stream(device: torch.device) -> torch.cuda.Stream:
    if device not in _streams:
        _streams[device] = torch.cuda.Stream(device=device)
    return _streams[device]


def _on_side_stream(device: torch.device, work: tp.Callable[[], tp.Any]) -> tp.Any:
    main = torch.cuda.current_stream(device)
    side = _stream(device)
    side.wait_stream(main)
    try:
        with torch.cuda.stream(side):
            return work()
    finally:
        main.wait_stream(side)


def _counts() -> list[int]:
    return [getattr(m, n) for m, n in _counters]


def _capture(prog: Program, tables: tuple) -> None:
    global captures, capturing
    if prog.device.type == "cuda":
        before = _counts()
        graph = torch.cuda.CUDAGraph()
        pool = _pool(prog.device)

        def work():
            graph.capture_begin(pool=pool.handle)
            try:
                out = prog.fn(tables, prog.bufs)
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass  # the capture is already invalid; keep fn's error
                raise
            graph.capture_end()
            return out

        capturing = prog
        try:
            prog.outputs = _on_side_stream(prog.device, work)
        finally:
            capturing = None
            after = _counts()
            for (m, n), a, b in zip(_counters, before, after):
                setattr(m, n, a)  # the capture launched nothing
        prog.launches = {
            c: b - a for c, a, b in zip(_counters, before, after) if b != a
        }
        prog.graph, prog.pool = graph, pool
    prog.captured = True
    captures += 1


def _replay(prog: Program, tables: tuple) -> tuple:
    global replays
    for ob in observers:
        ob(prog, "before")
    if prog.graph is None:
        prog.outputs = prog.fn(tables, prog.bufs)
    else:
        prog.graph.replay()
        for (m, n), k in prog.launches.items():
            setattr(m, n, getattr(m, n) + k)
    replays += 1
    for ob in observers:
        ob(prog, "after")
    return prog.outputs


def run(name: tp.Hashable, fn: Fn, tables: tuple, bufs: Buffers) -> tuple:
    r"""Run program ``name`` (``fn`` with its static parameters; one
    ``name`` always names the same function) on ``tables`` and ``bufs``:
    dispatched at its key's first use, captured at the second, replayed
    from then on.  Returns ``fn``'s outputs, valid until the next run of
    any program."""
    global warmups
    key = (name, tuple(map(_ident, tables)), tuple(map(_ident, bufs.values())))
    program = name[0] if isinstance(name, tuple) else name
    prog = _programs.get(key)
    if prog is None:
        with spans.span("program.warmup", program):
            _programs[key] = Program(key, fn, tables, bufs)
            warmups += 1
            device = tables[0].device
            if device.type == "cuda":
                return _on_side_stream(device, lambda: fn(tables, bufs))
            return fn(tables, bufs)
    if not prog.captured:
        with spans.span("program.capture", program):
            _capture(prog, tables)
    with spans.span("program.replay", program):
        return _replay(prog, tables)
