r"""Spans of the batch engine's host driver: where a fit spends its host time,
and which part of the program launched each piece of device work.

Recording is off unless turned on::

    from bblean_tpu_torch.engine import spans

    spans.on = True
    tree.fit_packed(fps, range(len(fps)))
    spans.on = False
    records = spans.take()  # the records, and the list is cleared

While :data:`on` is false a boundary costs a call that tests it and
hands back a shared do-nothing context (or calls the function it wraps):
no allocation, no clock read, no torch call.  While it is true each span
that closes appends one :class:`Span` to an in-memory list; nothing is
written anywhere.  One host thread drives a tree, and the recorder
assumes it: the open spans form one stack.

A record is ``(name, id, parent, start_ns, end_ns, root, program)``:

- ``id`` counts up from 1 in the process; ``parent`` is the span open
  when this one opened (0: none); ``root`` is the outermost span open at
  the time, so every span of one fit carries its ``fit`` span's id, and
  every span of one refine (the fit of its exploded rows included) its
  ``refine`` span's id, as a request id;
- ``start_ns`` and ``end_ns`` are read from ``time.time_ns()``, the clock
  on which ``torch.profiler`` stamps its host events, so a span can be
  laid over a profile: a kernel belongs to the innermost span open when
  its launch call started;
- ``program`` names the device program of a ``program.*`` span (``wide``,
  ``narrow``, ``split``), None elsewhere.

Records are appended when a span closes: a child comes before its parent.

The spans (``engine/batch.py`` unless named):

========================  ==================================================
``fit``                   ``BatchTree.fit_packed``, the root of a fit
                          called on its own
``stage_chunk``           a host chunk padded, made contiguous and copied
                          to the device
``window``                one scan window (``_submit_scan``), with the
                          boundaries it settles
``step``                  one batch step (``_batch_step_impl``)
``step.prep``             the step's rows unpacked, routed, sorted and
                          copied into the programs' buffers
``program.warmup``        a program run dispatched at its key's first use,
``program.capture``       captured at its second (a replay follows),
``program.replay``        replayed after (``engine/graphs.py::run``)
``round.<stage>``         a stage of a dispatched insert round
                          (``ROUND_STAGES``); a captured or replayed round
                          runs no Python of its own, so it has none
``refresh``               the step's counters copied out and the touched
                          clusters' and groups' centroids refreshed
``split``                 a split pass, and the check that decides it
``boundary``              a scan window's flush boundary settled
``retry``                 a window's or batch's pending rows retried
``grow``                  the tables grown (``_grow_state``)
``sync``                  a device-to-host read (``_host``): the host waits
                          for the device; always a leaf
``refine``                ``BatchTree.refine_inplace``, the root of a
                          refine
``refine.extract``        the clusters' sizes and order, their members as
                          one flat id array, the survivors' counts and sums
                          gathered on the device, and the tree reset
``refine.load``           the exploded rows read back from the input
                          (``_load_rows_by_mol``); their ``fit`` follows
``buffers``               ``BatchTree.insert_buffers`` (a user's host CF
                          rows) or a refine's or recluster's survivors: CF
                          buffer rows, one batch step each batch
``buffers.stage``         one batch of buffers made step rows: a user's
                          padded, made contiguous and copied to the device;
                          survivors gathered and padded on the device
========================  ==================================================
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import time
import typing as tp

__all__ = ["Span", "on", "span", "spanned", "take"]

# Whether spans are recorded
on = False


class Span(tp.NamedTuple):
    name: str
    id: int
    parent: int  # 0: no span was open
    start_ns: int
    end_ns: int
    root: int  # the outermost span open (a fit's ``fit`` span, a refine's ``refine``)
    program: str | None = None


_records: list[tuple] = []  # Span fields; made Spans by take()
_stack: list[int] = []  # ids of the open spans, innermost last
_ids = itertools.count(1)


class _Open:
    __slots__ = ("name", "program", "id", "parent", "root", "start")

    def __init__(self, name: str, program: str | None) -> None:
        self.name, self.program = name, program

    def __enter__(self) -> "_Open":
        self.id = next(_ids)
        self.parent = _stack[-1] if _stack else 0
        self.root = _stack[0] if _stack else self.id
        _stack.append(self.id)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        end = time.time_ns()
        # A span left open by an exception inside this one closes with it
        del _stack[_stack.index(self.id):]
        _records.append((self.name, self.id, self.parent, self.start, end, self.root, self.program))


_OFF = contextlib.nullcontext()


def span(name: str, program: str | None = None) -> tp.ContextManager:
    r"""A context that records one span named ``name`` while :data:`on`
    is true, and does nothing otherwise."""
    return _Open(name, program) if on else _OFF


def spanned(name: str) -> tp.Callable[[tp.Callable], tp.Callable]:
    r"""Decorate a function so that each call is one span named ``name``
    while :data:`on` is true."""

    def wrap(fn: tp.Callable) -> tp.Callable:
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not on:
                return fn(*args, **kwargs)
            with _Open(name, None):
                return fn(*args, **kwargs)

        return call

    return wrap


def take() -> list[Span]:
    r"""The spans recorded since the last call, in the order they closed;
    the list is cleared."""
    out = [Span._make(r) for r in _records]
    _records.clear()
    return out
