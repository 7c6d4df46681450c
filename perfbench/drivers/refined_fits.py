r"""Refined fits: a library fit followed by the refine that ``bb run
--refine-num K`` runs on it, one job after another.

A job is what the command line does for one library (``cli.py``,
``_run_batch_engine``): a fresh ``BatchTree`` at the configuration's
settings, ``fit_packed`` of the host array, then ``refine_inplace`` of the
same array with the traffic mix's ``refine`` settings (the ``K`` largest
clusters exploded and refitted, every other cluster re-inserted whole as a
CF buffer), then ``num_clusters`` and a device synchronise.

Set-up makes the library as ``library_fits`` does (``perfbench/library.py``,
copied to the host once), then warms the program at this cell's shapes: a
warm tree fits the first ``warm_prefix_rows`` rows, runs ``warm_programs``
and refines its ``K`` largest clusters (the tolerance criteria's kernels
built or loaded, the buffer steps' working set in the caching allocator),
and is freed.

The window runs jobs until ``seconds`` have passed; the job running at the
deadline finishes and counts.  ``fit_rate`` is library rows times jobs over
the jobs' summed walls.  Between the fit and the refine of each job the
clustering before the refine is read to the host (``assignments()``), for
the reference, outside the job's wall: at 1M rows the read is one
device-to-host copy of the rows' cluster ids and a host scatter, 10-35 ms
on an H100's host (each read's wall is in the run's notes), and the refine
then finds the ids on the host, where it would otherwise copy them itself
(the same single copy).  The card's peak allocated memory is reset before
each job and read after it.  With ``trace``, the window's first refine runs
under ``torch.profiler``, started outside the job's wall (the fit before it
unprofiled), and the window holds at least one more job, unprofiled: the
device metrics are of the profiled refine, its idle share read against the
median wall of the unprofiled refines.  After the window the last job's
refined clustering is held to the plain reference
(``perfbench/reference_refine.py``) with the refined share of rows merged
and the limits the traffic mix states for the configuration.

The program's counters are read where the program has them; one it lacks
(an older program) is left out, and the metric that reads it finds
nothing.
"""

from __future__ import annotations

import importlib
import resource
import statistics
import time
import typing as tp

import numpy as np
import torch

from perfbench import reference_refine
from perfbench.drivers.library_fits import TRACED, _reduce_trace
from perfbench.library import make_library
from perfbench.observe import Observation

__all__ = ["run"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _counters(names: tp.Iterable[str]) -> dict[str, int]:
    r"""The current value of each ``"module:name"`` counter that exists."""
    out = {}
    for ref in names:
        mod, attr = ref.split(":")
        value = getattr(importlib.import_module(mod), attr, None)
        if value is not None:
            out[ref] = int(value)
    return out


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
    lib, ref = traffic["library"], traffic["reference"][config["name"]]
    k = traffic["refine"]["n_largest"]
    settings = dict(
        threshold=config["threshold"], merge_criterion=config["merge_criterion"],
        tolerance=config["tolerance"], device=dev, **config["batch_tree"],
    )
    refine_threshold = config["threshold"] + traffic["refine"]["threshold_change"]
    refine_kw = dict(
        n_largest=k, threshold=refine_threshold,
        merge_criterion=traffic["refine"]["merge_criterion"],
        tolerance=traffic["refine"]["tolerance"],
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
    warm.refine_inplace(host[:n_warm], **refine_kw)
    warm.num_clusters
    del warm
    _sync(dev)
    setup_s = time.perf_counter() - t_start

    # ---- window ----
    counters = tuple(counters)
    before = _counters(counters)
    walls: list[float] = []  # jobs: fit and refine
    refine_walls: list[float] = []
    read_walls: list[float] = []
    peaks: list[int] = []
    prof = None
    tree = pre = None
    start = time.perf_counter()
    while True:
        tree = pre = None  # the previous job's tables go before the next one
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        tree = tree_cls(n_features, **settings)
        tree.fit_packed(host, range(n))
        tree.num_clusters
        _sync(dev)
        t1 = time.perf_counter()
        pre = tree.assignments()
        read_walls.append(time.perf_counter() - t1)
        traced = trace_on and not walls
        if traced:
            from torch.profiler import ProfilerActivity, profile, record_function

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
            prof = profile(activities=acts)
            prof.start()
            rng = record_function(TRACED)
            rng.__enter__()
        t2 = time.perf_counter()
        tree.refine_inplace(host, **refine_kw)
        tree.num_clusters  # a read of the device's count: the refine's last sync
        _sync(dev)
        t3 = time.perf_counter()
        if traced:
            rng.__exit__(None, None, None)
            prof.stop()
        walls.append((t1 - t0) + (t3 - t2))
        refine_walls.append(t3 - t2)
        peaks.append(torch.cuda.max_memory_allocated(dev) if on_card else 0)
        if t3 - start >= seconds and (not trace_on or len(walls) >= 2):
            break
    after = _counters(counters)

    out: dict[str, tp.Any] = {
        "attempted": len(walls),
        "end_to_end": {"fit_rate": n * len(walls) / sum(walls), "setup_s": setup_s},
        "memory_peak_bytes": max(peaks),
        "walls": walls,
    }
    if on_card:
        out["end_to_end"]["fit_peak_mem"] = max(peaks) / 2**30

    # ---- the reference, on the last job's refined clustering ----
    sizes_pre = np.bincount(pre[pre >= 0])
    top = np.sort(sizes_pre)[::-1][:k]
    sizes = tree.cluster_sizes()
    rss_gib = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    out["notes"] = [
        f"refine walls {refine_walls} s (median {statistics.median(refine_walls):.3f}); "
        f"reads of the clustering before the refine {read_walls} s",
        f"before the refine: clusters {len(sizes_pre)}, the {k} largest {top.tolist()} "
        f"({int(top.sum())} rows exploded), survivors {len(sizes_pre) - len(top)}; after: "
        f"clusters {len(sizes)}, singletons {int((sizes == 1).sum())}, rows merged "
        f"{n - len(sizes)} of {n}",
        f"card peak {max(peaks)} B; host peak RSS {rss_gib:.2f} GiB",
    ]
    readings = reference_refine.check_refine(
        torch.from_numpy(host).to(dev), pre, tree.assignments(), sizes,
        {t: getattr(tree.state, t) for t in reference_refine.TABLES},
        refine_threshold, ref["merge_share"], k,
    )
    limits = ref["limits"]
    out["compared"] = [(name, readings[name], limits[name]) for name in reference_refine.NAMES]
    out["correct"] = all(v <= lim for _k, v, lim in out["compared"])
    out["failed"] = 0 if out["correct"] else 1
    del tree

    obs = Observation(
        rows=n * len(walls), deltas={c: after[c] - before[c] for c in after if c in before},
        claimed=claimed,
    )
    if prof is not None:
        t0 = time.perf_counter()
        traced = _reduce_trace(prof, refine_walls, n, obs)
        del prof
        out["notes"] += [note.replace("fit", "refine") for note in traced.pop("notes")]
        out["notes"].append(f"trace read and reduced in {time.perf_counter() - t0:.1f} s")
        out.update(traced)
    out["observation"] = obs
    return out
