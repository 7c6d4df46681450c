r"""The span recorder (``bblean_tpu_torch/engine/spans.py``) on the CPU: a fit
records nothing while recording is off and the same labels either way; the
spans of a fit nest inside their parents and carry the fit's root id; the
``sync`` and ``program.*`` spans count what the engine's counters count;
a dispatched round records its stages in order and a capture none; and the
spans' clock is the one ``torch.profiler`` stamps its host events with.

The fit is 2,048 fingerprints at batch 64 on tiles of 32 cells (two scan
windows, each staged as its own chunk), so groups split and the tables
grow inside it."""

import functools
import time

import numpy as np
import pytest
import torch

from bblean_tpu_torch.engine import batch as tb, graphs, spans
from bblean_tpu_torch.fingerprints import make_fake_fingerprints

torch.set_num_threads(2)

SEED = 2**31 + 1907
N = 2048
TREE_KW = dict(
    batch_size=64, route_block=64, tile=32, fanout=24, initial_capacity=1024,
    stage_windows=1, device="cpu",
)
COUNTERS = {
    "sync": (tb, "host_syncs"),
    "program.warmup": (graphs, "warmups"),
    "program.capture": (graphs, "captures"),
    "program.replay": (graphs, "replays"),
}


@pytest.fixture(autouse=True)
def _recording_off():
    spans.on = False
    spans.take()
    yield
    spans.on = False
    spans.take()


@functools.lru_cache(maxsize=None)
def _fit(on: bool) -> tuple[np.ndarray, list[spans.Span], dict[str, int]]:
    r"""(labels, spans recorded, each counter's rise) of one fit."""
    fps = make_fake_fingerprints(N, seed=SEED)
    tree = tb.BatchTree(2048, threshold=0.3, **TREE_KW)
    before = {k: getattr(m, a) for k, (m, a) in COUNTERS.items()}
    spans.take()
    spans.on = on
    try:
        tree.fit_packed(fps, range(N))
    finally:
        spans.on = False
    records = spans.take()
    rise = {k: getattr(m, a) - before[k] for k, (m, a) in COUNTERS.items()}
    return tree.assignments(), records, rise


def test_recording_off_records_nothing_and_labels_match():
    labels_off, records_off, _ = _fit(False)
    labels_on, records_on, _ = _fit(True)
    assert records_off == []
    assert records_on
    np.testing.assert_array_equal(labels_off, labels_on)


def test_spans_nest_inside_their_parents_under_one_root():
    _labels, records, _ = _fit(True)
    by_id = {r.id: r for r in records}
    (root,) = [r for r in records if r.parent == 0]
    assert root.name == "fit" and root.root == root.id
    for r in records:
        assert r.root == root.id
        assert r.start_ns <= r.end_ns
        if r is not root:
            p = by_id[r.parent]
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns, (r, p)
    # Every boundary of the fit path that this fit crosses
    names = {r.name for r in records}
    assert {
        "fit", "stage_chunk", "window", "step", "step.prep", "program.warmup",
        "program.capture", "program.replay", "refresh", "split", "boundary", "grow", "sync",
    } <= names
    assert sum(r.name == "stage_chunk" for r in records) == 2
    # sync spans are leaves; a program span names its program
    assert not any(by_id[r.parent].name == "sync" for r in records if r.parent)
    assert {r.program for r in records if r.name.startswith("program.")} == {"wide", "narrow", "split"}
    assert {r.program for r in records if not r.name.startswith("program.")} == {None}


@pytest.mark.parametrize("name", sorted(COUNTERS))
def test_span_counts_equal_the_counters_rise(name):
    _labels, records, rise = _fit(True)
    assert rise[name] > 0
    assert sum(r.name == name for r in records) == rise[name]


def test_dispatched_rounds_record_their_stages_in_order():
    _labels, records, _ = _fit(True)
    by_id = {r.id: r for r in records}
    rounds: dict[int, list[spans.Span]] = {}
    for r in records:
        if r.name.startswith("round."):
            assert by_id[r.parent].name in ("program.warmup", "program.replay")
            rounds.setdefault(r.parent, []).append(r)
    assert rounds
    for stages in rounds.values():
        stages.sort(key=lambda r: r.start_ns)
        assert [r.name for r in stages] == [f"round.{s}" for s in tb.ROUND_STAGES]
        assert all(a.end_ns <= b.start_ns for a, b in zip(stages, stages[1:]))


def test_a_capture_records_no_stages(monkeypatch):
    monkeypatch.setattr(graphs, "capturing", object())
    spans.on = True
    stage = tb._Stages()
    stage("search")
    stage.end()
    assert spans.take() == []
    monkeypatch.setattr(graphs, "capturing", None)
    stage("search")
    stage.end()
    assert [r.name for r in spans.take()] == ["round.search"]


def test_nesting_ids_and_take():
    spans.on = True

    @spans.spanned("outer")
    def outer(x):
        with spans.span("inner", "wide"):
            return x + 1

    assert outer(1) == 2
    inner, out = spans.take()
    assert (inner.name, inner.program, out.name, out.program) == ("inner", "wide", "outer", None)
    assert inner.parent == out.id == inner.root == out.root and out.parent == 0
    assert spans.take() == []
    spans.on = False
    assert outer(2) == 3
    assert spans.take() == []


def test_a_span_closed_by_an_exception_closes_what_it_left_open():
    spans.on = True
    with pytest.raises(ValueError):
        with spans.span("outer"):
            spans.span("left open").__enter__()
            raise ValueError
    (out,) = spans.take()
    assert out.name == "outer"
    with spans.span("next"):
        pass
    (nxt,) = spans.take()
    assert nxt.parent == 0 and nxt.root == nxt.id


def test_spans_share_the_profilers_host_clock():
    from torch.profiler import ProfilerActivity, profile, record_function

    with record_function("warm"):  # the first range pays for set-up
        pass
    spans.on = True
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm"):
            pass
        with spans.span("around"):
            with record_function("spans.inner"):
                time.sleep(0.002)
    (around,) = spans.take()
    (inner,) = [
        e for e in prof.profiler.kineto_results.events() if e.name() == "spans.inner"
    ]
    assert around.start_ns <= inner.start_ns() <= around.start_ns + 1_000_000
    assert inner.end_ns() <= around.end_ns <= inner.end_ns() + 1_000_000
