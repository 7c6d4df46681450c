r"""The port's fit path by its own spans (``bblean_tpu_torch/engine/spans.py``)
on one NVIDIA GPU: host time by layer, device time by the span that
launched it, idle gaps by what the program was doing, and what recording
costs.

Run from the repository root::

    python3 chip_spans.py --workload fit-1m-t030 --seed 2147483747 [--pairs 4] [--out PATH]

For one cell of ``BENCHMARK.json`` it sets up as
``perfbench/drivers/library_fits.py`` does (the seeded library made on the
card and copied to the host, a warm tree fitted and freed), then:

1. fits the library ``2 x pairs`` times unprofiled, with span recording
   off and on in turns (off, on, on, off, ...): the cost of recording is
   the on fits' median wall over the off fits'.  For each fit with spans,
   the five host times of ``perfbench/attribution.py::host_ms`` per
   million rows and their sum against the fit's wall, the ``sync`` and
   ``program.*`` spans against the rise of ``engine.batch.host_syncs`` and
   ``engine.graphs``' counters, and host self time by span;
2. fits it once more under ``torch.profiler`` (CPU and CUDA activity) with
   spans on: device time of the events launched inside ``program.*``
   spans and inside any other span, their sum against the union of the
   device intervals (busy), the shares of device and idle time that a span
   owns, what none owns, and device time and idle gaps by span;
3. checks the clock: a ``record_function`` range inside a span, and the
   launch of a kernel inside it, on the card's profiler;
4. times one boundary on this host, with recording off and on (a ``with``
   span and a decorated call, mean of 200,000), for the cost of the
   spans a fit records.

A fit, as the driver times it, is the tree's construction, ``fit_packed``
of the host array, ``num_clusters`` and a device synchronise.  Prints one
JSON line; ``--out`` writes it to a file too.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

from bblean_tpu_torch import BatchTree  # noqa: E402
from bblean_tpu_torch.engine import batch as engine, graphs, spans  # noqa: E402
from perfbench import attribution, manifest  # noqa: E402
from perfbench.library import make_library  # noqa: E402

DEVICE = "cuda"
COUNTERS = {
    "sync": (engine, "host_syncs"),
    "program.warmup": (graphs, "warmups"),
    "program.capture": (graphs, "captures"),
    "program.replay": (graphs, "replays"),
}
# The seven metrics' names for the parts of host_ms, and the device parts
HOST_METRICS = {
    "sync": "fit.sync_host_ms", "replay": "fit.replay_host_ms",
    "capture": "fit.capture_host_ms", "staging": "fit.staging_host_ms",
    "dispatch": "fit.dispatch_host_ms",
}


def _setup(cell: str, seed: int):
    man = manifest.load(ROOT)
    w = man.workloads[cell]
    config, traffic = man.config(w["config"]), man.traffic(w["traffic"])
    lib = traffic["library"]
    dev = torch.device(DEVICE)
    settings = dict(
        threshold=config["threshold"], merge_criterion=config["merge_criterion"],
        tolerance=config["tolerance"], device=dev, **config["batch_tree"],
    )
    n, f = config["n_rows"], config["n_features"]
    library = make_library(
        n, f, seed, popcount_loc=lib["popcount_loc"], popcount_scale=lib["popcount_scale"],
        popcount_min=lib["popcount_min"], popcount_max=lib["popcount_max"],
        chunk_rows=lib["chunk_rows"], device=dev,
    )
    host = library.cpu().numpy()
    del library
    warm = BatchTree(f, **settings)
    n_warm = min(traffic["warm_prefix_rows"], n)
    warm.fit_packed(host[:n_warm], range(n_warm))
    warm.warm_programs(host[: warm.scan_batches * warm.batch_size])
    del warm
    _sync()
    return host, n, f, settings


def _fit(host, n, f, settings, *, on: bool):
    r"""(wall s, clusters, spans, counters' rise) of one fit."""
    before = {k: getattr(m, a) for k, (m, a) in COUNTERS.items()}
    spans.take()
    spans.on = on
    try:
        t0 = time.perf_counter()
        tree = BatchTree(f, **settings)
        tree.fit_packed(host, range(n))
        clusters = tree.num_clusters
        _sync()
        wall = time.perf_counter() - t0
    finally:
        spans.on = False
    del tree
    rise = {k: getattr(m, a) - before[k] for k, (m, a) in COUNTERS.items()}
    return wall, clusters, spans.take(), rise


def _sync() -> None:
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def _self_ms(records) -> dict[str, float]:
    child: dict[int, int] = defaultdict(int)
    for s in records:
        child[s.parent] += s.end_ns - s.start_ns
    out: dict[str, float] = defaultdict(float)
    for s in records:
        out[attribution.label(s)] += (s.end_ns - s.start_ns - child[s.id]) / 1e6
    return dict(out)


def _top(ms: dict[str, float], k: int = 10) -> list:
    return [[name, v] for name, v in sorted(ms.items(), key=lambda kv: -kv[1])[:k]]


def _host_fit(wall, records, rise, n) -> dict:
    (fit,) = [s for s in records if s.name == "fit"]
    parts = attribution.host_ms(records, fit.id)
    mrow = n / 1e6
    return {
        "wall_s": wall,
        "fit_span_s": parts["fit"] / 1e3,
        "metrics": {HOST_METRICS[p]: parts[p] / mrow for p in HOST_METRICS},
        "sum_over_wall": sum(parts[p] for p in HOST_METRICS) / 1e3 / wall,
        "spans": len(records),
        "counts": {k: [sum(s.name == k for s in records), rise[k]] for k in COUNTERS},
        "self_ms_by_span": _top(_self_ms(records), 14),
    }


def _profiled(host, n, f, settings) -> dict:
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    lo = time.time_ns()
    wall, _clusters, records, _rise = _fit(host, n, f, settings, on=True)
    hi = time.time_ns()
    prof.stop()
    t0 = time.perf_counter()
    device = attribution.launches(prof)
    del prof
    dev = attribution.device_by_span(device, records, lo, hi)
    idle = attribution.idle_by_span(device, records, lo, hi)
    mrow = n / 1e6
    idle_ns = sum(idle.values())
    busy = dev["busy_ns"] or None  # none on a device the profiler does not trace
    return {
        "wall_s": wall,
        "window_s": (hi - lo) / 1e9,
        "busy_s": dev["busy_ns"] / 1e9,
        "device_events": len(device),
        "fit.program_device_ms": dev["program_ns"] / 1e6 / mrow,
        "fit.eager_device_ms": dev["eager_ns"] / 1e6 / mrow,
        "device_sum_over_busy": busy and (dev["program_ns"] + dev["eager_ns"]) / busy,
        "device_total_over_busy": busy and dev["total_ns"] / busy,
        "device_attributed": busy and (dev["program_ns"] + dev["eager_ns"]) / dev["total_ns"],
        "idle_attributed": 1 - idle.get(attribution.NO_SPAN, 0) / idle_ns if idle_ns else None,
        "idle_s": idle_ns / 1e9,
        "device_by_span": _top({k: v / 1e9 for k, v in dev["by_span"].items()}),
        "idle_by_span": _top({k: v / 1e9 for k, v in idle.items()}),
        "unattributed": _top({k[:100]: v / 1e9 for k, v in dev["unattributed"].items()}, 8),
        "reduced_in_s": time.perf_counter() - t0,
    }


def _clock() -> dict:
    r"""A ``record_function`` range and a kernel's launch inside a span,
    under the card's profiler: how far each lies inside the span."""
    from torch.profiler import ProfilerActivity, profile, record_function

    x = torch.ones(1 << 20, device=DEVICE)
    _sync()
    spans.take()
    spans.on = True
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("clock.warm"):
            x.add_(1)
        with spans.span("clock"):
            with record_function("clock.inner"):
                x.mul_(2)
                time.sleep(0.002)
        _sync()
    spans.on = False
    (span,) = spans.take()
    (inner,) = [
        e for e in prof.profiler.kineto_results.events()
        if e.name() == "clock.inner" and e.device_type() == torch.autograd.DeviceType.CPU
    ]
    launched = [
        t for k, name, s, e, t in attribution.launches(prof) if "mul" in name.lower()
    ]
    return {
        "range_start_after_span_us": (inner.start_ns() - span.start_ns) / 1e3,
        "span_end_after_range_us": (span.end_ns - inner.end_ns()) / 1e3,
        "kernel_launch_after_span_us": [(t - span.start_ns) / 1e3 if t else None for t in launched],
    }


def _boundary_ns(reps: int = 200_000) -> dict:
    r"""Host ns of one boundary: a ``with`` span and a decorated call, with
    recording off and on, less the same loop without a boundary."""
    def bare():
        return None

    decorated = spans.spanned("cost")(bare)

    def loop(body) -> float:
        t0 = time.perf_counter_ns()
        for _ in range(reps):
            body()
        return (time.perf_counter_ns() - t0) / reps

    def with_span():
        with spans.span("cost"):
            pass

    out = {}
    for on in (False, True):
        spans.on = on
        base = loop(bare)
        out["on" if on else "off"] = {"with": loop(with_span) - base, "decorated": loop(decorated) - base}
        spans.on = False
        spans.take()
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--pairs", type=int, default=4)
    ap.add_argument("--out")
    args = ap.parse_args()
    if DEVICE == "cuda" and not torch.cuda.is_available():
        raise SystemExit("chip_spans.py needs a CUDA device")
    card = DEVICE if DEVICE != "cuda" else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()
    out: dict = {"workload": args.workload, "seed": args.seed, "card": card,
                 "torch": torch.__version__, "clock": _clock(), "boundary_ns": _boundary_ns()}
    host, n, f, settings = _setup(args.workload, args.seed)
    walls: dict[bool, list[float]] = {False: [], True: []}
    fits = []
    clusters = set()
    for i in range(2 * args.pairs):
        on = (i % 4) in (1, 2)
        wall, ncl, records, rise = _fit(host, n, f, settings, on=on)
        walls[on].append(wall)
        clusters.add(ncl)
        if on:
            fits.append(_host_fit(wall, records, rise, n))
    if len(clusters) != 1:
        raise AssertionError(f"fits gave other cluster counts: {clusters}")
    out["clusters"] = clusters.pop()
    out["walls_off_s"], out["walls_on_s"] = walls[False], walls[True]
    out["cost_on"] = statistics.median(walls[True]) / statistics.median(walls[False]) - 1
    out["fits_with_spans"] = fits
    out["profiled"] = _profiled(host, n, f, settings)
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()
