r"""Side-by-side run of two checkouts of the port on one NVIDIA GPU.

Run from the repository root:
``python3 chip_ab.py OTHER_DIR [--order ABBA] [--out PATH]``.
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
fit's wall and device busy time, and the kernels whose device time
differs most between the two; ``--cprofile`` fits once more per checkout
under ``cProfile`` and prints the functions whose host time differs most;
``--events`` fits once more per checkout (ABBA) with CUDA events around
each launch of the search and plan wrappers and prints their summed
device time beside the fit's wall; ``--rounds`` times, per checkout
(ABBA), an emulated insert round (60 small elementwise kernels, one search
launch at the fit's average shape, one scalar read) against the same round
without the search, for each front end: the wall one launch adds to a
round; and the host time of one call of each wrapper enqueued behind
20 ms of device work (``torch.cuda._sleep``), which shows whether the call
waits for the device; ``--timers`` fits once more per checkout (ABBA)
with host timers (inclusive wall) around the engine's step functions, its
host reads and the search wrappers.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import cProfile
import json
import os
import pstats
import sys
import time

import numpy as np
import torch

import chip_smoke as cs

ROOT = os.path.dirname(os.path.abspath(__file__))
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
    ts._lib()
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
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tree, _ncl = _fit(BatchTree, dev_fps, cs.N_FPS)
    wall = time.perf_counter() - t0
    del tree
    torch.cuda.empty_cache()
    per: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            per[e.name] = per.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy = sum(per.values())
    cs.say(f"ab profiled {label}: fit {wall:.3f} s wall, device busy {busy:.1f} ms")
    return {"label": label, "wall_s": wall, "busy_ms": busy, "by_kernel_ms": per}


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


def _round_walls(label: str, tree_dir: str, reps: int = 200) -> dict:
    r"""Median wall of an emulated round with and without one search launch
    at the fit's average shapes (``chip_smoke.SORTED_FIT``, ``ROWS_FIT``)."""
    _BatchTree, _engine, ts = _use(tree_dir)
    gen = torch.Generator(device="cuda").manual_seed(5)
    g, fc, f8 = 4096, 256, 256
    x = torch.rand(8192, device="cuda")
    calls = {"none": lambda: None}
    for front, m, route in (("sorted", 8192, cs.SORTED_FIT), ("rows", 2048, cs.ROWS_FIT)):
        row_pk, row_pop, row_group, t_pk, t_pops, t_slot, pending = cs._search_case(
            gen, m, g, fc, f8, route
        )
        if front == "sorted":
            plan = ts.sorted_search_plan(torch.where(pending, row_group, g - 1))
            order, skey, extra = plan[0], plan[1], plan[2:]
            srows, spops, plan_key = row_pk[order], row_pop[order], skey
            calls[front] = (
                lambda srows=srows, spops=spops, skey=skey, order=order, t=(t_pk, t_pops, t_slot),
                pending=pending, extra=extra: ts.tile_search_planned(
                    srows, spops, skey, order, *t, pending, *extra
                )
            )
        else:
            args = (row_pk, row_pop, torch.where(pending, row_group, g + 7), t_pk, t_pops, t_slot, pending)
            calls[front] = lambda args=args: ts.tile_search_rows(*args)

    def one_round(search):
        y = x
        for _ in range(30):
            y = y * 1.0001 + 0.0001
        out = search()
        return float(y[0]) + (0.0 if out is None else float(out[0][0]))

    walls = {}
    for name, search in calls.items():
        for _ in range(10):
            one_round(search)
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            one_round(search)
            times.append(time.perf_counter() - t0)
        walls[name] = float(np.median(times)) * 1e3
    cs.say(
        f"ab rounds {label}: median round wall without a search {walls['none']:.4f} ms, "
        f"with the sorted search {walls['sorted']:.4f} ms, with the per-row search "
        f"{walls['rows']:.4f} ms (median of {reps})"
    )
    # Host time of one call behind 20 ms of device work: about 20 ms if the
    # call waits for the device, far less if it only enqueues
    cycles = int(20e-3 * torch.cuda.get_device_properties(0).clock_rate * 1e3)
    behind = {}
    probes = dict(calls)
    if hasattr(ts, "plan_items"):
        probes["plan"] = lambda: ts.plan_items(plan_key)
    for name, search in probes.items():
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        t0 = time.perf_counter()
        search()
        behind[name] = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
    cs.say(
        f"ab behind 20 ms of device work {label}: host ms of one call "
        + ", ".join(f"{k} {v:.3f}" for k, v in behind.items())
    )
    return {"label": label, "round_ms": walls, "behind_ms": behind}


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
    ap.add_argument("other", help="directory holding the other checkout's bblean_tpu_torch/")
    ap.add_argument("--order", default="ABBAABBA")
    ap.add_argument("--out", help="JSON file for every run's numbers")
    ap.add_argument("--profile", action="store_true", help="one profiled fit per checkout")
    ap.add_argument("--cprofile", action="store_true", help="one cProfile'd fit per checkout")
    ap.add_argument("--events", action="store_true", help="fits (ABBA) with events per launch")
    ap.add_argument("--rounds", action="store_true", help="emulated rounds (ABBA) with each search")
    ap.add_argument("--timers", action="store_true", help="fits (ABBA) with host timers")
    args = ap.parse_args()
    if set(args.order) - {"A", "B"}:
        raise SystemExit("--order takes the letters A and B")
    trees = {"A": os.path.abspath(args.other), "B": ROOT}
    cs.phase_device()
    rounds = [_round_walls(label, trees[label]) for label in "ABBA"] if args.rounds else []
    fits = args.order or args.profile or args.cprofile or args.events or args.timers
    _use(ROOT)
    from bblean_tpu_torch.fingerprints import make_fake_fingerprints

    fps = make_fake_fingerprints(cs.N_FPS if fits else 0, cs.N_FEATURES, seed=cs.SEED)
    dev_fps = torch.from_numpy(fps).to("cuda")
    queries = fps[:131_072]
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
                "profiled": profiled, "host_profiled": host, "events": events, "rounds": rounds, "timers": timers,
            }, f)


if __name__ == "__main__":
    main()
