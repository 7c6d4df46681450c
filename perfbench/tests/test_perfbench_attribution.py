r"""Device time and idle gaps laid over the program's spans
(``perfbench/attribution.py``), on a synthetic trace: a replayed graph
whose kernels share one launch, eager work and a copy inside a read, a
gap with no span open, and an event whose launch the profile lacks."""

from __future__ import annotations

import typing as tp

import pytest
import torch

from perfbench import attribution as at


class Span(tp.NamedTuple):
    name: str
    id: int
    parent: int
    start_ns: int
    end_ns: int
    root: int
    program: str | None = None


SPANS = [
    Span("fit", 1, 0, 0, 1000, 1),
    Span("stage_chunk", 2, 1, 10, 60, 1),
    Span("window", 3, 1, 60, 900, 1),
    Span("program.replay", 4, 3, 100, 150, 1, "wide"),
    Span("sync", 5, 3, 200, 300, 1),
    Span("program.warmup", 6, 3, 400, 500, 1, "narrow"),
    Span("round.search", 7, 6, 410, 450, 1),
    Span("sync", 8, 0, 1100, 1200, 8),  # a read after the fit: a root of its own
]
# (kind, name, start, end, correlation id)
DEVICE = [
    ("memcpy", "Memcpy HtoD (Pageable -> Device)", 20, 50, 1),
    # One graph replay: three kernels, one launch
    ("kernel", "void round_a(int)", 160, 200, 7),
    ("kernel", "void round_b(int)", 200, 260, 7),
    ("kernel", "void round_c(int)", 260, 300, 7),
    ("memcpy", "Memcpy DtoH (Device -> Pageable)", 300, 310, 9),
    ("kernel", "void tile_search_kernel(int)", 420, 470, 11),
    ("kernel", "void eager_op(int)", 600, 700, 12),
    ("kernel", "void lost(int)", 700, 720, 99),  # its launch is not in the profile
    ("kernel", "void late(int)", 900, 950, 13),  # launched in the fit, after its window
]
CALLS = [
    ("cudaMemcpyAsync", 15, 18, 1),
    ("cudaGraphLaunch", 110, 140, 7),
    ("cudaMemcpyAsync", 205, 210, 9),
    ("cudaLaunchKernel", 415, 418, 11),
    ("cudaLaunchKernel", 560, 570, 12),
    ("cudaLaunchKernel", 950, 960, 13),  # between the fit's end and the read
]


def _launched():
    return at.link(DEVICE, CALLS)


def test_link_gives_every_kernel_of_a_replay_its_one_launch():
    launched = _launched()
    assert [ev[4] for ev in launched] == [15, 110, 110, 110, 205, 415, 560, None, 950]
    # An id of 0 is the profiler's own record, linked to nothing
    assert at.link([("kernel", "k", 0, 1, 0)], [("cudaLaunchKernel", 0, 1, 0)]) == [
        ("kernel", "k", 0, 1, None)
    ]


def test_innermost_span_at_each_time():
    times = [455, 5, 420, 1000, 1001, 120, 1150]
    names = [s and s.name for s in at.innermost(SPANS, times)]
    assert names == [
        "program.warmup", "fit", "round.search", "fit", None, "program.replay", "sync",
    ]


def test_device_time_by_the_span_that_launched_it():
    out = at.device_by_span(_launched(), SPANS, 0, 1000)
    assert out["by_span"] == {
        "stage_chunk": 30,
        "program.replay(wide)": 140,
        "sync": 10,
        "round.search": 50,
        "window": 100,
        at.UNLINKED: 20,
        "fit": 50,
    }
    # The replay, and the warm-up's stage: programs; the rest eager
    assert out["program_ns"] == 190
    assert out["eager_ns"] == 30 + 10 + 100 + 50
    assert out["unattributed_ns"] == 20
    assert out["unattributed"] == {"void lost(int)": 20}
    assert out["total_ns"] == out["busy_ns"] == 30 + 140 + 10 + 50 + 100 + 20 + 50


def test_device_time_clips_to_the_window_and_counts_no_span():
    out = at.device_by_span(_launched(), SPANS, 0, 920)
    assert out["by_span"]["fit"] == 20
    early = [Span("fit", 1, 0, 100, 200, 1)]
    out = at.device_by_span(_launched(), early, 0, 1000)
    # Launched while no span was open, bar the replay's kernels
    assert out["by_span"][at.NO_SPAN] == 30 + 10 + 50 + 100 + 50
    assert out["program_ns"] == 0 and out["eager_ns"] == 140
    assert out["unattributed_ns"] == 30 + 10 + 50 + 100 + 50 + 20


def test_idle_gaps_by_the_span_open_at_their_midpoint():
    idle = at.idle_by_span(_launched(), SPANS, 0, 1100)
    # Gaps [0,20] mid 10 in staging; [50,160] mid 105 in the replay; [310,420] mid 365 in
    # the window; [470,600] mid 535 in the window; [720,900] mid 810 in the
    # window; [950,1100] mid 1025 in no span
    assert idle == {
        "stage_chunk": 20,
        "program.replay(wide)": 110,
        "window": 110 + 130 + 180,
        at.NO_SPAN: 150,
    }
    busy = at.device_by_span(_launched(), SPANS, 0, 1100)["busy_ns"]
    assert sum(idle.values()) == 1100 - busy


def test_host_times_add_up_to_the_fit():
    spans = SPANS + [Span("grow", 9, 2, 20, 30, 1)]  # a child inside staging
    parts = at.host_ms(spans, 1)
    assert parts["sync"] == 100 / 1e6  # the read after the fit is not the fit's
    assert parts["replay"] == 50 / 1e6
    assert parts["capture"] == 100 / 1e6
    assert parts["staging"] == (50 - 10) / 1e6
    assert parts["fit"] == 1000 / 1e6
    assert sum(parts[p] for p in ("sync", "replay", "capture", "staging", "dispatch")) == pytest.approx(
        parts["fit"], abs=1e-15
    )


def test_labels_name_the_program():
    assert at.label(SPANS[3]) == "program.replay(wide)"
    assert at.label(SPANS[4]) == "sync"


class _Event:
    r"""An event of the profiler as torch 2.11 gives it, with its
    correlation id."""

    def __init__(self, name, device, corr, start=0, end=1, annotation=False, index=0):
        self._v = name, device, corr, start, end, annotation, index

    def name(self):
        return self._v[0]

    def device_type(self):
        return getattr(torch.autograd.DeviceType, self._v[1])

    def correlation_id(self):
        return self._v[2]

    def start_ns(self):
        return self._v[3]

    def end_ns(self):
        return self._v[4]

    def is_user_annotation(self):
        return self._v[5]

    def device_index(self):
        return self._v[6]


def test_launches_of_a_profile_link_through_runtime_calls():
    evs = [
        _Event("perfbench.traced_fit", "CPU", 5, 0, 100, annotation=True),
        _Event("perfbench.traced_fit", "CUDA", 5, 0, 100, annotation=True),
        _Event("aten::add_", "CPU", 3, 10, 20),  # a torch op's id is not a launch's
        _Event("cudaLaunchKernel", "CPU", 3, 12, 14),
        _Event("cudaGraphLaunch", "CPU", 4, 30, 35),
        _Event("void add_kernel(int)", "CUDA", 3, 40, 50),
        _Event("void round_a(int)", "CUDA", 4, 50, 60),
        _Event("void round_b(int)", "CUDA", 4, 60, 70),
        _Event("Memset (Device)", "CUDA", 8, 70, 71),
    ]
    prof = type("P", (), {"profiler": type("K", (), {
        "kineto_results": type("R", (), {"events": staticmethod(lambda: evs)})()
    })()})()
    assert at.launches(prof) == [
        ("kernel", "void add_kernel(int)", 40, 50, 12),
        ("kernel", "void round_a(int)", 50, 60, 30),
        ("kernel", "void round_b(int)", 60, 70, 30),
        ("memset", "Memset (Device)", 70, 71, None),
    ]
