r"""Library fits: one ``BatchTree.fit_packed`` after another, as ``bb run
--engine batch`` calls it.

Set-up makes the configuration's library on the device from the seed
(``perfbench/library.py``), copies it to the host once (the CLI hands
``fit_packed`` a host array) and frees the device copy, then warms the
program at this cell's shapes only: a warm tree fits the first
``warm_prefix_rows`` rows and runs ``warm_programs`` (kernels built or
loaded, the caching allocator holding the step's working set), and is
freed.

The window fits the whole library with a fresh tree, again and again,
until ``seconds`` have passed; the fit running at the deadline finishes
and counts.  A fit is the tree's construction, ``fit_packed`` of the host
array, ``num_clusters`` and a device synchronise.  The card's peak
allocated memory is reset before each fit and read after it.  With
``trace``, the window's first fit runs under ``torch.profiler`` (CPU and
CUDA activity: the device's events, and the host's that label its idle
gaps), and the window holds at least one more fit, unprofiled: recording
the host's events stretches the profiled fit's wall, not its device time,
so the device's idle share is read against the unprofiled fits' wall.
After the window the last tree's clustering is held to the plain
reference (``perfbench/reference.py``).
"""

from __future__ import annotations

import statistics
import time
import typing as tp

import torch

from perfbench import reference, trace
from perfbench.library import make_library
from perfbench.observe import Observation, read_counters

__all__ = ["run"]

# The profiler range around the traced fit; it bounds the traced stretch
TRACED = "perfbench.traced_fit"
# The tables of BatchTree.state that the reference judges
TABLES = ("n", "ls_ref", "ls", "group", "pos", "t_pk", "t_slot")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _reduce_trace(prof, walls: list[float], n: int, obs: Observation) -> dict:
    r"""``device``, ``breakdown`` and notes of a traced run, and its profiled
    fit's device events into ``obs`` (that fit is ``walls[0]``, of ``n``
    rows; the window's other fits ran unprofiled)."""
    device_ev, host_ev = trace.events(prof)
    (lo, hi), = [(s, e) for name, s, e in host_ev if name == TRACED]
    device_ev = [(k, nm, max(s, lo), min(e, hi)) for k, nm, s, e in device_ev if e > lo and s < hi]
    host_ev = [h for h in host_ev if h[0] != TRACED]
    untraced = statistics.median(walls[1:])
    obs.traced_rows, obs.traced_ns, obs.device = n, hi - lo, device_ev
    obs.untraced_ns = int(untraced * 1e9)
    obs.kernel_sums = trace.sums_by_name([ev for ev in device_ev if ev[0] == "kernel"])
    busy = trace.busy_ns(device_ev)
    return {
        "device": {"busy_s": busy / 1e9, "window_s": (hi - lo) / 1e9},
        "breakdown": {
            "device_ops": trace.top(trace.sums_by_name(device_ev)),
            "idle_gaps": trace.top(trace.idle_by_host(device_ev, host_ev, lo, hi), shorten=False),
        },
        "notes": [
            f"trace: {len(device_ev)} device and {len(host_ev)} host events; profiled fit "
            f"{(hi - lo) / 1e9:.3f} s, device busy {busy / 1e9:.3f} s; unprofiled fits' median "
            f"{untraced:.3f} s",
        ],
    }


def run(
    config: dict,
    traffic: dict,
    *,
    seed: int,
    seconds: float,
    trace_on: bool,
    device: str,
    t_start: float,
    counters: tp.Iterable[str] = (),
    claimed: tuple[str, ...] = (),
    tree_cls: type | None = None,
) -> dict:
    r"""One run; returns the numbers that ``perfbench/run.py`` prints.

    ``t_start`` is the process's start on ``time.perf_counter``;
    ``counters`` are the program's counters the metrics read;
    ``tree_cls`` replaces ``bblean_tpu_torch.BatchTree`` (tests put a broken
    one there).
    """
    if tree_cls is None:
        from bblean_tpu_torch import BatchTree as tree_cls
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    n, n_features = config["n_rows"], config["n_features"]
    lib = traffic["library"]
    settings = dict(
        threshold=config["threshold"], merge_criterion=config["merge_criterion"],
        tolerance=config["tolerance"], device=dev, **config["batch_tree"],
    )

    # ---- set-up ----
    library = make_library(
        n, n_features, seed,
        popcount_loc=lib["popcount_loc"], popcount_scale=lib["popcount_scale"],
        popcount_min=lib["popcount_min"], popcount_max=lib["popcount_max"],
        chunk_rows=lib["chunk_rows"], device=dev,
    )
    host = library.cpu().numpy()
    del library
    if on_card:
        torch.cuda.empty_cache()
    warm = tree_cls(n_features, **settings)
    n_warm = min(traffic["warm_prefix_rows"], n)
    warm.fit_packed(host[:n_warm], range(n_warm))
    warm.warm_programs(host[: warm.scan_batches * warm.batch_size])
    del warm
    _sync(dev)
    setup_s = time.perf_counter() - t_start

    # ---- window ----
    counters = tuple(counters)
    before = read_counters(counters)
    walls: list[float] = []
    peaks: list[int] = []
    prof = None
    tree = None
    start = time.perf_counter()
    while True:
        tree = None  # the previous library's tables go before the next fit
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        traced = trace_on and not walls
        if traced:
            from torch.profiler import ProfilerActivity, profile, record_function

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
            prof = profile(activities=acts)
            prof.start()
            rng = record_function(TRACED)
            rng.__enter__()
        t0 = time.perf_counter()
        tree = tree_cls(n_features, **settings)
        tree.fit_packed(host, range(n))
        tree.num_clusters  # a read of the device's count: the fit's last sync
        _sync(dev)
        t1 = time.perf_counter()
        if traced:
            rng.__exit__(None, None, None)
            prof.stop()
        walls.append(t1 - t0)
        peaks.append(torch.cuda.max_memory_allocated(dev) if on_card else 0)
        if t1 - start >= seconds and (not trace_on or len(walls) >= 2):
            break
    window_s = t1 - start
    after = read_counters(counters)

    out: dict[str, tp.Any] = {
        "attempted": len(walls),
        "end_to_end": {"fit_rate": n * len(walls) / window_s, "setup_s": setup_s},
        "memory_peak_bytes": max(peaks),
        "walls": walls,
    }
    if on_card:
        out["end_to_end"]["fit_peak_mem"] = max(peaks) / 2**30

    # ---- the reference, on the last library's clustering ----
    sizes = tree.cluster_sizes()
    out["notes"] = [
        f"clusters {len(sizes)}, singletons {int((sizes == 1).sum())}, rows merged "
        f"{n - len(sizes)} of {n}"
    ]
    readings = reference.check_clustering(
        torch.from_numpy(host).to(dev), tree.assignments(), sizes,
        {k: getattr(tree.state, k) for k in TABLES},
        config["threshold"], config["merge_criterion"], config["merge_share"],
    )
    limits = config["limits"]
    out["compared"] = [(k, readings[k], limits[k]) for k in reference.NAMES]
    out["correct"] = all(v <= lim for _k, v, lim in out["compared"])
    out["failed"] = 0 if out["correct"] else 1
    del tree

    obs = Observation(rows=n * len(walls), deltas={k: after[k] - before[k] for k in counters}, claimed=claimed)
    if prof is not None:
        t0 = time.perf_counter()
        traced = _reduce_trace(prof, walls, n, obs)
        del prof
        out["notes"] += traced.pop("notes")
        out["notes"].append(f"trace read and reduced in {time.perf_counter() - t0:.1f} s")
        out.update(traced)
    out["observation"] = obs
    return out
