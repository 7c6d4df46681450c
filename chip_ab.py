r"""Side-by-side run of two checkouts of the port on one NVIDIA GPU.

Run from the repository root:
``python3 chip_ab.py OTHER_DIR [--order ABBA] [--out PATH]``, or
``python3 chip_ab.py --order '' --rounds --dispatch`` for this checkout
alone.
``OTHER_DIR`` holds another checkout's ``bblean_tpu_torch/`` (for example
the parent commit: ``git archive HEAD bblean_tpu_torch | tar -x -C DIR``,
in a directory that ``.gitignore`` lists).  Each letter of ``--order`` is
one run in this process: "A" the port under ``OTHER_DIR``, "B" the port of
this checkout.  Before each run the modules of ``bblean_tpu_torch`` are
dropped and imported again from that checkout, so both run on one card,
one host and one input (``chip_smoke.py``'s 1M x 2048-bit fingerprints).

A run fits the input at t = 0.3 (wall, clusters, host syncs), predicts
131,072 of its rows at batch 8192 (three walls), and times the sorted and
the per-row search on the tree's tables at M = 1000, 1024 and 8192 with
``chip_smoke._time_predict_searches`` (CUDA events, median of 15; the
sorted search's in-call sort and plan included).  Cluster counts and
predicted slots and sims must be equal across runs.  A warm-up fit of
50,000 rows per checkout comes first.  ``--profile`` then fits once more
per checkout under ``torch.profiler`` (CUDA activity) and prints each
fit's wall and device busy time, the launches and device ms of
``torch.cumsum``'s outer-dimension scan, of the prefix-commit kernel
(with the sum of its calls' bounds from the rows each call's mask lets
in, logged by ``chip_smoke._PrefixWork`` in one more fit, not profiled,
so the log's small kernels stay out of the profile), of each launch of
the leader election (the earlier design's two or this one's three) and of
the pool and tile writes' kernels, its ten kernels of most device time,
and the kernels whose device time differs most between the two; ``--cprofile`` fits once more per checkout
under ``cProfile`` and prints the functions whose host time differs most;
``--events`` fits once more per checkout (ABBA) with CUDA events around
each launch of the search and plan wrappers and prints their summed
device time beside the fit's wall; ``--rounds`` times, in each checkout
(``OTHER_DIR`` first, where it is given), one insert round replayed as a CUDA graph against the same round
dispatched op by op, at the wide (8,192) and narrow (2,048) widths
(:func:`_round_walls`), and each width's round once more, dispatched
under the profiler, split by the stages of the round
(:func:`_stage_split`: device ms per stage, and the bytes the round
allocates), before any fit; ``--dispatch`` fits this
checkout in turns with its programs replayed and with them dispatched
(:func:`_graphs_against_dispatch`); ``--timers`` fits once more per checkout (ABBA)
with host timers (inclusive wall) around the engine's step functions, its
host reads and the search wrappers.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import cProfile
import functools
import inspect
import json
import os
import pstats
import sys
import time

import numpy as np
import torch

import chip_smoke as cs

ROOT = os.path.dirname(os.path.abspath(__file__))
# The prefix-commit kernels of a checkout of the earlier three-launch design
_THREE_LAUNCH_KERNELS = ("tails_kernel", "carry_kernel", "moments_kernel")
# The leader election's launches in a checkout of the earlier design (a warp a row)
_WARP_ELECTION_KERNELS = ("election_leads_kernel", "election_argmax_kernel")
THRESHOLD = 0.3


def _use(tree_dir: str):
    r"""Import ``bblean_tpu_torch`` afresh from ``tree_dir``; returns its
    (BatchTree, engine module, tile_search module) with the kernels built."""
    for name in [m for m in sys.modules if m.split(".")[0] == "bblean_tpu_torch"]:
        del sys.modules[name]
    dirs = {os.path.abspath(tree_dir), ROOT}
    sys.path[:] = [tree_dir] + [p for p in sys.path if os.path.abspath(p or ".") not in dirs]
    from bblean_tpu_torch import BatchTree
    from bblean_tpu_torch.engine import batch as engine
    from bblean_tpu_torch.ops import tile_search as ts

    if not ts.__file__.startswith(os.path.abspath(tree_dir)):
        raise AssertionError(f"imported {ts.__file__}, not from {tree_dir}")
    ts.kernel.lib()
    return BatchTree, engine, ts


def _fit(BatchTree, dev_fps, n: int):
    tree = BatchTree(
        cs.N_FEATURES, threshold=THRESHOLD, batch_size=8192, device="cuda",
        **cs.FIT_SETTINGS[THRESHOLD],
    )
    tree.fit_packed(dev_fps[:n], range(n))
    ncl = tree.num_clusters
    torch.cuda.synchronize()
    return tree, ncl


def _run(label: str, tree_dir: str, dev_fps, queries: np.ndarray) -> tuple[dict, tuple]:
    BatchTree, engine, _ts = _use(tree_dir)
    syncs0 = engine.host_syncs
    t0 = time.perf_counter()
    tree, ncl = _fit(BatchTree, dev_fps, cs.N_FPS)
    fit_s = time.perf_counter() - t0
    syncs = engine.host_syncs - syncs0
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        pred = tree.predict_packed(queries, batch=8192)
        walls.append(time.perf_counter() - t0)
    search = cs._time_predict_searches(tree, queries)
    del tree
    torch.cuda.empty_cache()
    out = {
        "label": label, "fit_s": fit_s, "clusters": ncl, "host_syncs": syncs,
        "predict_8192_s": walls, "search_ms": {str(m): v for m, v in search.items()},
    }
    cs.say(
        f"ab {label}: fit {fit_s:.3f} s, {ncl} clusters, {syncs} host syncs; "
        f"predict of {len(queries)} at batch 8192 "
        f"{', '.join(f'{w:.4f}' for w in walls)} s; sorted search per call "
        + ", ".join(f"M={m} {v[0]:.4f} ms" for m, v in search.items())
    )
    return out, pred


def _profiled(label: str, tree_dir: str, dev_fps) -> dict:
    r"""One fit under the profiler: wall, device busy ms, device ms by kernel."""
    from torch.profiler import ProfilerActivity, profile

    BatchTree, _engine, _ts = _use(tree_dir)
    try:
        prefix = cs._PrefixWork(log=False)  # a checkout that has the prefix-commit kernel
    except ImportError:
        prefix = contextlib.nullcontext()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof, prefix:
        tree, _ncl = _fit(BatchTree, dev_fps, cs.N_FPS)
    wall = time.perf_counter() - t0
    del tree
    torch.cuda.empty_cache()
    per: dict[str, float] = {}
    count: dict[str, int] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            per[e.name] = per.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
            count[e.name] = count.get(e.name, 0) + 1
    busy = sum(per.values())

    def kernels(*names):
        keys = [k for k in per if any(n in k for n in names)]
        return sum(count[k] for k in keys), sum(per[k] for k in keys)

    scans, scan_ms = kernels("scan_outer_dim")
    # One kernel a call; a checkout of the earlier design launched three a
    # call (chunk tails, carry, rescan), counted by the last
    launches, prefix_ms = kernels(*cs.PREFIX_KERNELS)
    if not launches:
        launches, prefix_ms = kernels("moments_kernel")[0], kernels(*_THREE_LAUNCH_KERNELS)[1]
    bound = bound_full = 0.0
    if launches:
        with cs._PrefixWork() as logged:
            tree, _ncl = _fit(BatchTree, dev_fps, cs.N_FPS)
        del tree
        torch.cuda.empty_cache()
        if [n[:4] for n in logged.seen] != [n[:4] for n in prefix.seen]:
            raise AssertionError("the logged fit's prefix-commit launches differ from the profiled fit's")
        bound, bound_full = logged.bound_ms(), logged.bound_ms(full=True)
        cs.say(f"ab profiled {label} prefix-commit traffic: {logged.traffic_text()}")
    cs.say(
        f"ab profiled {label}: fit {wall:.3f} s wall, device busy {busy:.1f} ms; "
        f"torch.cumsum outer-dimension scans {scans} launches, {scan_ms:.1f} ms; "
        f"prefix-commit kernel {launches} launches, {prefix_ms:.1f} ms, bound {bound:.1f} ms, "
        f"above bound {prefix_ms - bound:.1f} ms (with cand_ls read whole: bound "
        f"{bound_full:.1f} ms, above it {prefix_ms - bound_full:.1f} ms)"
    )
    election_names = cs.ELECTION_KERNELS if kernels(cs.ELECTION_KERNELS[0])[0] else _WARP_ELECTION_KERNELS
    election = {n: kernels(n) for n in election_names}
    cs.say(
        f"ab profiled {label}: leader election kernels {sum(v[0] for v in election.values())} "
        f"launches, {sum(v[1] for v in election.values()):.1f} device ms ("
        + ", ".join(f"{n} {v[0]} launches {v[1]:.2f} ms" for n, v in election.items()) + ")"
    )
    # A checkout of the earlier design named its second launch
    # writes_adds_tiles_kernel
    n, ms = kernels(*cs.WRITES_KERNELS, "writes_adds_tiles_kernel")
    cs.say(f"ab profiled {label}: pool and tile writes kernels {n} launches, {ms:.2f} device ms")
    for k in sorted(per, key=lambda k: -per[k])[:10]:
        cs.say(f"ab profiled {label} top kernel: {per[k]:.1f} ms, {count[k]} launches: {k[:160]}")
    return {
        "label": label, "wall_s": wall, "busy_ms": busy, "by_kernel_ms": per,
        "launches": count,
        "election": {n: {"launches": v[0], "device_ms": v[1]} for n, v in election.items()},
        "writes": {"launches": n, "device_ms": ms},
        "prefix_commit": {
            "launches": launches, "device_ms": prefix_ms, "bound_ms": bound,
            "bound_full_ms": bound_full,
            "scan_outer_dim_launches": scans, "scan_outer_dim_ms": scan_ms,
        },
    }


def _host_profiled(label: str, tree_dir: str, dev_fps) -> dict:
    r"""One fit under cProfile: host seconds by (file, function), summed
    over line numbers so that the two checkouts' keys meet."""
    BatchTree, _engine, _ts = _use(tree_dir)
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    tree, _ncl = _fit(BatchTree, dev_fps, cs.N_FPS)
    prof.disable()
    wall = time.perf_counter() - t0
    del tree
    torch.cuda.empty_cache()
    per: dict[str, list] = {}
    for (path, _line, func), (_cc, ncalls, tottime, _ct, _callers) in pstats.Stats(prof).stats.items():
        key = f"{os.path.basename(path)}:{func}"
        v = per.setdefault(key, [0, 0.0])
        v[0] += ncalls
        v[1] += tottime
    cs.say(f"ab cProfile {label}: fit {wall:.3f} s wall")
    return {"label": label, "wall_s": wall, "by_function": per}


def _event_timed(label: str, tree_dir: str, dev_fps) -> dict:
    r"""One fit with CUDA events around each launch of the tile-search
    module's launch functions: device ms and launches by function."""
    BatchTree, _engine, ts = _use(tree_dir)
    names = [n for n in ("_launch", "_launch_rows", "plan_items") if hasattr(ts, n)]
    marks: list = []

    def timed(name, fn):
        def call(*a, **k):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **k)
            end.record()
            marks.append((name, start, end))
            return out
        return call

    saved = {n: getattr(ts, n) for n in names}
    for n in names:
        setattr(ts, n, timed(n, saved[n]))
    try:
        t0 = time.perf_counter()
        tree, _ncl = _fit(BatchTree, dev_fps, cs.N_FPS)
        wall = time.perf_counter() - t0
    finally:
        for n in names:
            setattr(ts, n, saved[n])
    del tree
    torch.cuda.empty_cache()
    per = {n: [0, 0.0] for n in names}
    for n, a, b in marks:
        per[n][0] += 1
        per[n][1] += a.elapsed_time(b)
    cs.say(
        f"ab events {label}: fit {wall:.3f} s wall; "
        + "; ".join(f"{n} {v[1]:.3f} ms over {v[0]} calls" for n, v in per.items())
    )
    return {"label": label, "wall_s": wall, "by_function_ms": per}


def _round_walls(tree_dir: str, dev_fps, reps: int = 40) -> dict:
    r"""One insert round replayed as a CUDA graph against the same round
    dispatched op by op (``engine/graphs.py``), at the wide width (8,192
    rows on the step's sorted plan) and the narrow one (2,048 compacted
    rows on the per-row search), in the checkout under ``tree_dir``.

    The state is a t = 0.3 fit of 200,000 rows at the 1M settings, and the
    round inserts the next batch.  Before each timed round the tables and
    the step's buffers are restored from a copy (same addresses), so every
    round does the same work; a round's wall runs from its dispatch to the
    host read of the loop's condition, as in the step.  Median of ``reps``
    per kind, taken in turns D R R D."""
    BatchTree, engine, _ts = _use(tree_dir)
    graphs = engine.graphs
    m, narrow = 8192, 2048
    tree, _ncl = _fit(BatchTree, dev_fps, 200_000)
    state = tree.state
    thr, tol = tree._scalars()
    tables = engine._tables(state)

    def stage(batch: int):
        rows = engine._slice_prep_fp_rows_impl(dev_fps, 200_000 + batch * m, m, m, cs.N_FEATURES)
        # A checkout from before the row Gram went takes the criterion
        kw = {"criterion": "diameter"} if "criterion" in inspect.signature(engine._stage_step).parameters else {}
        return engine._stage_step(state, *rows, thr, tol, block=tree.route_block, **kw)

    bufs = stage(0)
    programs = {
        "wide": (("wide", "diameter"), functools.partial(engine._wide_round, criterion="diameter")),
        "narrow": (
            ("narrow", "diameter", narrow),
            functools.partial(engine._narrow_round, criterion="diameter", narrow=narrow),
        ),
    }
    out: dict = {}
    for kind in ("wide", "narrow"):
        if kind == "narrow":
            # Run the wide rounds as the step does until <= 2,048 rows pend,
            # on the next batches until one leaves some pending (a step
            # whose wide rounds take every row runs no narrow round)
            name, fn = programs["wide"]
            for batch in range(1, 17):
                bufs = stage(batch)
                while int(engine._isum(bufs["pending"])) > narrow:
                    engine._carry(bufs, graphs.run(name, fn, tables, bufs))
                if int(engine._isum(bufs["pending"])) > 0:
                    break
            else:
                raise AssertionError("no batch of 16 left rows for a narrow round")
        saved = [t.clone() for t in tables], {k: v.clone() for k, v in bufs.items()}
        name, fn = programs[kind]

        def restore():
            for t, c in zip(tables, saved[0]):
                t.copy_(c)
            for k, v in saved[1].items():
                bufs[k].copy_(v)
            torch.cuda.synchronize()

        def one(run):
            restore()
            t0 = time.perf_counter()
            engine._carry(bufs, run())
            left = int(engine._isum(bufs["pending"]))
            return time.perf_counter() - t0, left

        ways = {
            "dispatched": lambda: fn(tables, bufs),
            "replayed": lambda: graphs.run(name, fn, tables, bufs),
        }
        for _ in range(3):  # warm-up, capture, one replay
            for way in ways.values():
                one(way)
        walls: dict = {"dispatched": [], "replayed": []}
        lefts = set()
        for i in range(reps):
            for way in ("dispatched", "replayed", "replayed", "dispatched")[i % 2 * 2 :][:2]:
                wall, left = one(ways[way])
                walls[way].append(wall)
                lefts.add(left)
        if len(lefts) != 1:
            raise AssertionError(f"the {kind} round left {sorted(lefts)} rows pending across runs")
        pend0 = int(saved[1]["pending"].sum())
        med = {k: float(np.median(v)) * 1e3 for k, v in walls.items()}
        out[kind] = {"pending_in": pend0, "pending_out": lefts.pop(), **{f"{k}_ms": v for k, v in med.items()}}
        out[kind].update(_stage_split(kind, restore, lambda: engine._carry(bufs, fn(tables, bufs)), engine))
        cs.say(
            f"ab rounds: {kind} round (M {bufs['row_n'].shape[0] if kind == 'wide' else narrow}, "
            f"{pend0} rows pending in, {out[kind]['pending_out']} out): dispatched "
            f"{med['dispatched']:.4f} ms, replayed {med['replayed']:.4f} ms "
            f"({med['dispatched'] / med['replayed']:.2f}x; median of {reps} each, in turns)"
        )
        restore()
    del tree, state, tables, saved
    torch.cuda.empty_cache()
    return out


# Insert rounds of a 1M t = 0.3 fit (chip_smoke.py phase 4: its sorted and
# per-row search launches) and the device ms its rounds' torch planes took
# in the fit's profile before the round's election and writes were
# kernels (PERF.md §5), for the shares of the stage split
ROUNDS_PER_FIT = {"wide": 145, "narrow": 204}
ROUND_PLANES_MS = 752.0


def _stage_split(kind: str, restore, dispatch, engine) -> dict:
    r"""One dispatched round under ``torch.profiler`` (CUDA activity), split
    by the stages of ``engine._insert_round`` (``engine.ROUND_STAGES``):
    while it runs, each stage boundary (``engine._Stages``) launches a
    marker kernel (``torch.cuda._sleep``), and every kernel, copy and fill
    on the device between one marker and the next counts to that stage, the
    hand kernels (launched outside torch) included.  Per stage: device ms,
    kernels, the three kernels of most device time and the bytes allocated
    at the stage's peak above what was allocated before the round; the
    round's whole device ms and peak.  Each stage's ms times the fit's rounds of this kind
    (``ROUNDS_PER_FIT``) is printed beside its share of
    ``ROUND_PLANES_MS``.  A checkout without the stages gives the whole
    round only."""
    from torch.profiler import ProfilerActivity, profile

    marks: list = []
    peaks: dict = {}
    opened = ["before the first stage"]

    def close(name: str) -> None:
        # The stage that ends here: its peak allocation above the round's start
        peaks[opened[0]] = torch.cuda.max_memory_allocated() - base
        torch.cuda.reset_peak_memory_stats()
        opened[0] = name

    class Marked:
        def __call__(self, name: str) -> None:
            close(name)
            marks.append(name)
            torch.cuda._sleep(1)

        def end(self) -> None:
            close("after the round")
            marks.append("after the round")
            torch.cuda._sleep(1)

    staged = hasattr(engine, "_Stages")
    restore()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    if staged:
        plain_stages, engine._Stages = engine._Stages, Marked
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            dispatch()
            torch.cuda.synchronize()
    finally:
        if staged:
            engine._Stages = plain_stages
    close("")
    peak = max(peaks.values())
    events = sorted(
        (e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
        key=lambda e: e.time_range.start,
    )
    names = iter(marks)
    cur = "before the first stage"
    stages: dict = {}
    for e in events:
        if "spin_kernel" in e.name:
            cur = next(names)
            continue
        v = stages.setdefault(cur, {}).setdefault(e.name, [0, 0.0])
        v[0] += 1
        v[1] += e.time_range.elapsed_us() / 1e3
    if staged and len(marks) != len(engine.ROUND_STAGES) + 1:
        raise AssertionError(f"the round marked the stages {marks}")
    device = sum(v[1] for ks in stages.values() for v in ks.values())
    split = {}
    for name in (*getattr(engine, "ROUND_STAGES", ()), "before the first stage", "after the round"):
        ks = stages.get(name, {})
        ms = sum(v[1] for v in ks.values())
        top = sorted(ks.items(), key=lambda kv: -kv[1][1])[:3]
        split[name] = {
            "device_ms": ms, "kernels": sum(v[0] for v in ks.values()),
            "peak_bytes": peaks.get(name, 0),
            "fit_ms": ms * ROUNDS_PER_FIT[kind],
            "top": [(k[:90], n, ms_k) for k, (n, ms_k) in top],
        }
    cs.say(
        f"ab rounds split: {kind} round dispatched, device {device:.4f} ms, peak allocated "
        f"{peak / 2**20:.1f} MiB above the {base / 2**30:.3f} GiB before it; x "
        f"{ROUNDS_PER_FIT[kind]} {kind} rounds a 1M t=0.3 fit:"
    )
    for name, v in split.items():
        cs.say(
            f"  {name}: {v['device_ms']:.4f} ms, {v['kernels']} kernels, peak allocated "
            f"{v['peak_bytes'] / 2**20:.1f} MiB; a fit {v['fit_ms']:.1f} ms "
            f"({v['fit_ms'] / ROUND_PLANES_MS:.3f} of {ROUND_PLANES_MS:.0f}); "
            + ", ".join(f"{k} x{n} {ms:.4f}" for k, n, ms in v["top"])
        )
    return {"device_ms": device, "peak_bytes": peak, "stages": split}


def _graphs_against_dispatch(dev_fps, order: str = "RDDRRDDR") -> dict:
    r"""1M t = 0.3 fits of this checkout in turns: "R" as it runs (rounds
    and split passes replayed as CUDA graphs), "D" with every program
    dispatched op by op (``engine/graphs.py``'s ``run`` replaced by a direct
    call for that fit).  Per fit: wall, clusters, host syncs, peak
    allocated and reserved memory; counts must agree."""
    BatchTree, engine, _ts = _use(ROOT)
    graphs = engine.graphs
    run = graphs.run
    out: dict = {"R": [], "D": []}
    for label in order:
        if label == "D":
            graphs.run = lambda name, fn, tables, bufs: fn(tables, bufs)
        try:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            syncs0 = engine.host_syncs
            t0 = time.perf_counter()
            tree, ncl = _fit(BatchTree, dev_fps, cs.N_FPS)
            wall = time.perf_counter() - t0
        finally:
            graphs.run = run
        r = {
            "fit_s": wall, "clusters": ncl, "host_syncs": engine.host_syncs - syncs0,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "reserved_gib": torch.cuda.max_memory_reserved() / 2**30,
        }
        del tree
        out[label].append(r)
        cs.say(
            f"ab graphs {'replayed' if label == 'R' else 'dispatched'}: fit {wall:.3f} s, "
            f"{ncl} clusters, {r['host_syncs']} host syncs, peak {r['peak_gib']:.3f} GiB "
            f"allocated, {r['reserved_gib']:.3f} GiB reserved"
        )
    if len({r["clusters"] for rs in out.values() for r in rs}) != 1:
        raise AssertionError("replayed and dispatched fits gave other counts")
    cs.say(
        "ab graphs summary: fit medians replayed "
        f"{np.median([r['fit_s'] for r in out['R']]):.3f} s, dispatched "
        f"{np.median([r['fit_s'] for r in out['D']]):.3f} s"
    )
    return out


_TIMED_ENGINE = (
    "_host", "_scan_fit_packed_impl", "_batch_step_impl", "_insert_round",
    "_route_groups", "_refresh_touched", "_split_topk_impl",
    "_split_groups_device_impl", "_slice_prep_fp_rows_impl", "sorted_search_plan",
    "tile_search_planned", "tile_search_rows",
)


def _host_timed(label: str, tree_dir: str, dev_fps) -> dict:
    r"""One fit with ``time.perf_counter`` around each named engine
    function (inclusive of what it calls): seconds and calls by name."""
    BatchTree, engine, _ts = _use(tree_dir)
    per: dict[str, list] = {}

    def timed(name, fn):
        def call(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                v = per.setdefault(name, [0, 0.0])
                v[0] += 1
                v[1] += time.perf_counter() - t0
        return call

    names = [n for n in _TIMED_ENGINE if hasattr(engine, n)]
    saved = {n: getattr(engine, n) for n in names}
    for n in names:
        setattr(engine, n, timed(n, saved[n]))
    try:
        t0 = time.perf_counter()
        tree, _ncl = _fit(BatchTree, dev_fps, cs.N_FPS)
        wall = time.perf_counter() - t0
    finally:
        for n in names:
            setattr(engine, n, saved[n])
    del tree
    torch.cuda.empty_cache()
    cs.say(
        f"ab timers {label}: fit {wall:.3f} s wall; "
        + "; ".join(f"{n} {v[1]:.3f} s / {v[0]}" for n, v in per.items())
    )
    return {"label": label, "wall_s": wall, "by_function_s": per}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("other", nargs="?", help="directory holding the other checkout's bblean_tpu_torch/")
    ap.add_argument("--order", default="ABBAABBA")
    ap.add_argument("--out", help="JSON file for every run's numbers")
    ap.add_argument("--profile", action="store_true", help="one profiled fit per checkout")
    ap.add_argument("--cprofile", action="store_true", help="one cProfile'd fit per checkout")
    ap.add_argument("--events", action="store_true", help="fits (ABBA) with events per launch")
    ap.add_argument("--rounds", action="store_true", help="a replayed round against a dispatched one, and its stages")
    ap.add_argument("--timers", action="store_true", help="fits (ABBA) with host timers")
    ap.add_argument("--dispatch", action="store_true", help="fits of this checkout, replayed against dispatched")
    args = ap.parse_args()
    if set(args.order) - {"A", "B"}:
        raise SystemExit("--order takes the letters A and B")
    fits = args.order or args.profile or args.cprofile or args.events or args.timers
    if fits and args.other is None:
        raise SystemExit("the other checkout's directory is needed unless only --rounds or --dispatch runs (--order '')")
    trees = {"A": os.path.abspath(args.other or ROOT), "B": ROOT}
    cs.phase_device()
    _use(ROOT)
    from bblean_tpu_torch.fingerprints import make_fake_fingerprints

    fps = make_fake_fingerprints(
        cs.N_FPS if fits or args.rounds or args.dispatch else 0, cs.N_FEATURES, seed=cs.SEED
    )
    dev_fps = torch.from_numpy(fps).to("cuda")
    queries = fps[:131_072]
    rounds = {}
    for label in ("AB" if args.other else "B") if args.rounds else "":
        cs.say(f"ab rounds of {label}: {trees[label]}")
        rounds[label] = _round_walls(trees[label], dev_fps)
    dispatch = _graphs_against_dispatch(dev_fps) if args.dispatch else {}
    for label in "AB" if fits else "":
        BatchTree, _engine, _ts = _use(trees[label])
        t0 = time.perf_counter()
        _tree, ncl = _fit(BatchTree, dev_fps, 50_000)
        cs.say(f"ab warm-up {label}: 50,000 rows, {ncl} clusters in {time.perf_counter() - t0:.2f} s")
        del _tree

    runs, first = [], None
    for label in args.order:
        out, pred = _run(label, trees[label], dev_fps, queries)
        if first is None:
            first = (out["clusters"], pred)
        elif out["clusters"] != first[0] or not all(
            np.array_equal(a, b) for a, b in zip(pred, first[1])
        ):
            raise AssertionError(f"run {label} gave other clusters or predictions")
        runs.append(out)
    for label in sorted(set(args.order)):
        rs = [r for r in runs if r["label"] == label]
        cs.say(
            f"ab {label} summary: fit walls {[round(r['fit_s'], 3) for r in rs]} s, "
            f"median {np.median([r['fit_s'] for r in rs]):.3f} s; predict at batch 8192 "
            f"best {min(min(r['predict_8192_s']) for r in rs):.4f} s, median "
            f"{np.median([w for r in rs for w in r['predict_8192_s']]):.4f} s; sorted "
            f"search at M=8192 median {np.median([r['search_ms']['8192'][0] for r in rs]):.4f} ms"
        )
    profiled = [_profiled(label, trees[label], dev_fps) for label in "AB"] if args.profile else []
    if profiled:
        a, b = (p["by_kernel_ms"] for p in profiled)
        diff = sorted(set(a) | set(b), key=lambda k: -abs(b.get(k, 0.0) - a.get(k, 0.0)))
        for k in diff[:12]:
            cs.say(
                f"ab profiled kernel: A {a.get(k, 0.0):.3f} ms, B {b.get(k, 0.0):.3f} ms: {k[:160]}"
            )
    host = [_host_profiled(label, trees[label], dev_fps) for label in "AB"] if args.cprofile else []
    if host:
        a, b = (h["by_function"] for h in host)
        diff = sorted(set(a) | set(b), key=lambda k: -abs(b.get(k, [0, 0.0])[1] - a.get(k, [0, 0.0])[1]))
        for k in diff[:20]:
            (na, ta), (nb, tb) = a.get(k, [0, 0.0]), b.get(k, [0, 0.0])
            cs.say(f"ab cProfile function: A {ta:.3f} s ({na} calls), B {tb:.3f} s ({nb} calls): {k}")
    events = [_event_timed(label, trees[label], dev_fps) for label in "ABBA"] if args.events else []
    timers = [_host_timed(label, trees[label], dev_fps) for label in "ABBA"] if args.timers else []
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({
                "other": args.other, "order": args.order, "runs": runs,
                "profiled": profiled, "host_profiled": host, "events": events, "rounds": rounds, "timers": timers, "dispatch": dispatch,
            }, f)


if __name__ == "__main__":
    main()
