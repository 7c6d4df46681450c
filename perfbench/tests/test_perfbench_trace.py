r"""The trace arithmetic (``perfbench/trace.py``) on synthetic traces, and
its reading of a real profiler's host events."""

from __future__ import annotations

import torch

from perfbench import trace
from perfbench.observe import Observation, kernel_reader

# (kind, name, start, end) in ns: two streams overlap on 150-200
DEVICE = [
    ("kernel", "void route_wgmma_kernel(CUtensorMap, CUtensorMap, Params)", 100, 200),
    ("kernel", "void at::native::reduce_kernel<512, 1>(at::native::ReduceOp<long>)", 150, 260),
    ("memcpy", "Memcpy HtoD (Pageable -> Device)", 400, 500),
    ("memset", "Memset (Device)", 500, 520),
    ("kernel", "void tile_search_kernel<true, 8>(unsigned char const*, int const*)", 700, 800),
    ("kernel", "void route_kernel(Params)", 900, 950),
]
HOST = [
    ("aten::item", 250, 420),
    ("cudaStreamSynchronize", 260, 410),
    ("cudaGraphLaunch", 580, 690),
    ("insert_round/screen", 520, 1000),
]


def test_busy_counts_overlap_once():
    # [100, 260] + [400, 520] + [700, 800] + [900, 950]
    assert trace.busy_ns(DEVICE) == 160 + 120 + 100 + 50


def test_idle_share_of_a_window():
    lo, hi = 0, 1000
    idle = trace.idle_by_host(DEVICE, HOST, lo, hi)
    assert sum(idle.values()) == (hi - lo) - trace.busy_ns(DEVICE)
    # Gaps: [0,100] no host event; [260,400] mid 330 inside the sync;
    # [520,700] mid 610 inside the graph launch; [800,900] and [950,1000]
    # inside the range
    assert idle == {
        trace.NO_HOST_EVENT: 100,
        "cudaStreamSynchronize": 140,
        "cudaGraphLaunch": 180,
        "insert_round/screen": 150,
    }


def test_idle_share_clips_to_the_window():
    idle = trace.idle_by_host(DEVICE, HOST, 150, 450)
    assert sum(idle.values()) == 300 - (260 - 150) - (450 - 400)


def test_sums_by_name_and_top():
    sums = trace.sums_by_name(DEVICE)
    assert sums["Memcpy HtoD (Pageable -> Device)"] == 100
    ranked = trace.top(sums, k=2)
    assert ranked[0] == ["at::native::reduce_kernel<512, 1>", 110e-9]
    assert len(ranked) == 2 and ranked[1][1] == 100e-9


def test_short_names():
    assert trace.short_name("void (anonymous namespace)::route_kernel(Params)") == "route_kernel"
    assert trace.short_name("Memcpy HtoD (Pageable -> Device)") == "Memcpy HtoD"
    assert trace.short_name("void f<g(int)>(float)") == "f<g(int)>"


def test_kernel_names_match_whole_functions():
    assert trace.kernel_matches("void route_kernel(Params)", ("route_kernel",))
    assert trace.kernel_matches("void (anonymous namespace)::route_kernel(Params)", ("route_kernel",))
    assert not trace.kernel_matches("void route_wgmma_kernel(Params)", ("route_kernel",))
    assert trace.kernel_matches("void tile_search_kernel<true, 8>(int)", ("tile_search_kernel",))
    assert not trace.kernel_matches("void tile_search_kernel2(int)", ("tile_search_kernel",))
    route = ("route_wgmma_kernel", "route_kernel", "route_combine_kernel")
    sums = trace.sums_by_name([e for e in DEVICE if e[0] == "kernel"])
    assert trace.kernel_ns(sums, route) == 150
    assert trace.kernel_ns(sums, route + ("tile_search_kernel",), invert=True) == 110
    assert trace.kernel_ns(sums, ("election_best_kernel",)) is None


def test_kernel_reader_per_million_rows_and_nothing_to_read():
    read = kernel_reader(("route_kernel", "route_wgmma_kernel"))
    obs = Observation(
        rows=2_000_000, deltas={}, traced_rows=500_000, traced_ns=1000, device=DEVICE,
        kernel_sums=trace.sums_by_name([e for e in DEVICE if e[0] == "kernel"]),
    )
    assert abs(read(obs) - 150e-6 / 0.5) < 1e-12
    assert kernel_reader(("election_best_kernel",))(obs) is None
    assert read(Observation(rows=1, deltas={})) is None


def test_events_of_a_real_profile():
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("perfbench.test_range"):
            torch.ones(64, 64).sum().item()
    device, host = trace.events(prof)
    assert device == []
    names = {h[0] for h in host}
    assert "perfbench.test_range" in names and "aten::sum" in names
    (s, e), = [(s, e) for n, s, e in host if n == "perfbench.test_range"]
    assert all(s <= hs and he <= e for n, hs, he in host if n == "aten::sum")


class _Event:
    r"""An event of the profiler as torch 2.11 gives it: no activity type."""

    def __init__(self, name, device, annotation=False, index=0, start=0, end=1):
        self._v = name, device, annotation, index, start, end

    def name(self):
        return self._v[0]

    def device_type(self):
        return getattr(torch.autograd.DeviceType, self._v[1])

    def is_user_annotation(self):
        return self._v[2]

    def device_index(self):
        return self._v[3]

    def start_ns(self):
        return self._v[4]

    def end_ns(self):
        return self._v[5]


def test_events_without_activity_types():
    evs = [
        _Event("perfbench.traced_fit", "CPU", True, 118, 0, 100),
        _Event("aten::item", "CPU", index=118, start=10, end=20),
        _Event("Activity Buffer Request", "CPU", index=-1),
        _Event("perfbench.traced_fit", "CUDA", True, 0, 0, 100),
        _Event("", "CUDA", start=5, end=6),
        _Event("Memcpy HtoD (Pageable -> Device)", "CUDA", start=1, end=3),
        _Event("Memset (Device)", "CUDA", start=3, end=4),
        _Event("void route_kernel(Params)", "CUDA", start=4, end=9),
    ]
    prof = type("P", (), {"profiler": type("K", (), {
        "kineto_results": type("R", (), {"events": staticmethod(lambda: evs)})()
    })()})()
    device, host = trace.events(prof)
    assert device == [
        ("memcpy", "Memcpy HtoD (Pageable -> Device)", 1, 3),
        ("memset", "Memset (Device)", 3, 4),
        ("kernel", "void route_kernel(Params)", 4, 9),
    ]
    assert host == [("perfbench.traced_fit", 0, 100), ("aten::item", 10, 20)]


def test_the_readers_on_a_synthetic_trace():
    from conftest import ROOT
    from perfbench.manifest import load_module

    def reader(name):
        return load_module(ROOT / "perfbench" / "metrics" / f"{name}.py")

    kernels = [e for e in DEVICE if e[0] == "kernel"]
    claimed = tuple(k for m in ("fit.route_ms", "fit.tile_search_ms") for k in reader(m).KERNELS)
    obs = Observation(
        rows=4_000_000, deltas={"bblean_tpu_torch.engine.batch:host_syncs": 3000},
        traced_rows=1_000_000, traced_ns=1000, untraced_ns=860, device=DEVICE,
        kernel_sums=trace.sums_by_name(kernels), claimed=claimed,
    )
    assert reader("fit.h2d_ms").read(obs) == 100e-6
    # Against the unprofiled fits' wall, not the profiled one's
    assert reader("fit.device_idle").read(obs) == 1 - 430 / 860
    assert reader("fit.torch_ms").read(obs) == 110e-6
    assert reader("fit.route_ms").read(obs) == 150e-6
    assert reader("fit.tile_search_ms").read(obs) == 100e-6
    assert reader("fit.prefix_commit_ms").read(obs) is None
    assert reader("fit.host_syncs").read(obs) == 750.0
    empty = Observation(rows=1, deltas={})
    for name in ("fit.h2d_ms", "fit.device_idle", "fit.torch_ms", "fit.route_ms"):
        assert reader(name).read(empty) is None
