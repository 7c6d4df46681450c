r"""Smoke run of the PyTorch port on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``.  It needs one CUDA
device and ``nvcc``, imports no JAX, and prints one line per phase as soon
as the phase ends:

1. device: the card's name and power limit (then the line
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
   prints); build the tile-search kernels;
2. the tile-search kernel's sorted front end against its plain PyTorch
   version on the card, at the batch engine's shapes and at tied cells,
   items longer than the plan's 64 rows, 512-cell tiles and 104- and
   264-bit rows (the generic path, counted apart); sims bit-equal, slots
   equal where a candidate exists.  For rows on one, three and 4,095
   groups, and at the fit's average launch (7,408 of 8,192 rows pending on
   64 groups, from ``chip_profile.py``): the kernel's time (profiler) and
   its time per call with the host dispatch (events), the plain version's
   time, and the bound computed from the case's pending rows and distinct
   tiles, with what bounds it and the kernel's share of it;
   ``torch._int_mm`` of the unpacked bits, as information (intersections
   only, not the same function);
2b. the per-row front end against the same plain version, at the narrow
   rounds' and predict's shapes, with the same times and bounds (the fit's
   average per-row launch: 515 of 2,048 rows pending on 2 groups);
2c. the sort plan's item-table kernel against its plain version, at the
   fit's and predict's batches, timed on the fit's keys;
3. the port on the CPU (plain search) and on the card (kernels) give the
   same labels for 20,000 fingerprints after the fit, a shuffled
   recluster and a refine, and the same predicted slots and sims for
   2,000 queries at an aligned and an unaligned batch size;
4. the fit path at full size: 1M x 2048-bit fingerprints at t = 0.3 and
   t = 0.65 through ``BatchTree.fit_packed``, no launch on the kernel's
   generic path, every molecule assigned once,
   sampled clusters meeting the diameter criterion in float64, and the
   cluster counts exactly the port's own (397,552 and 983,222; their
   distance to the JAX engine's record is printed as information);
5. on the t = 0.3 tree of phase 4: ``predict_packed`` of 131,072 queries
   through the sorted kernel (batch 8192) and the per-row kernel (batch
   1000), identical and equal to a float64 Tanimoto against the packed
   centroids; both kernels timed on the tree's tables at batches of 1000,
   1024 and 8192; then ``refine_inplace`` of the largest cluster, with every
   molecule assigned once, sampled linear sums equal to their members'
   bits and sampled clusters meeting the diameter criterion;
6. the command line at full size (``bblean_tpu_torch.cli.main`` in this
   process, on ``.npy`` files written under a temporary directory): (a) the
   1M fingerprints in one file at t = 0.3, (b) in two files with
   ``--refine-num 1``, (c) in one file at t = 0.65; each run's
   ``clusters.pkl`` holds every molecule once in clusters of non-increasing
   size, as many as ``config.json`` says, sampled clusters meet the
   diameter criterion and sampled stored centroids are their members'
   majority vote; the walls of the fit (reading and staging included), of each
   extraction and of each pickle are printed beside the resident-input fit's,
   with the cost of reading and staging alone; (d) 20,000 fingerprints with
   ``--device cpu`` and on the card give byte-equal ``clusters.pkl`` and
   centroids;
7. the side ops on the card against the same functions on the CPU:
   popcount and Tanimoto of 8,192 x 2048-bit rows against 1,024 centroids
   (equal), k-means of 100,000 unpacked centroids of the 1M tree into 1,000
   clusters (two calls equal; CPU against CUDA on 10,000 rows), t-SNE of
   5,000 of them over 750 iterations (finite; 5 iterations against the CPU
   on 2,000 rows to 1e-3 of the embedding's scale, 10 and 20 printed);
8. the sharded engine, every shard on ``cuda:0``: (a) one shard, the 1M
   fingerprints at t = 0.3 at the bench's settings, fit + merge; (b) eight
   shards at t = 0.3 and t = 0.65, twice each: fit wall, merge wall and its
   share, per merge round the received groups appended (far) and gated to
   the row-level path (close), the rows inserted, retries and growths, the
   kernels' launches in the fit and in the merge (none generic), peak
   memory; every molecule labelled once, sizes equal to the label
   histogram, 200 sampled linear sums equal to their members' bits, 1,000
   sampled clusters meeting the diameter criterion at the merge threshold,
   both runs' labels identical; (c) 20,000 fingerprints on four CPU shards
   and four shards of the card give identical labels; (d) inside the merges
   of (b), sampled launches of both tile-search front ends are held
   bit-equal to the plain version on the merge's own inputs; (e) the
   command line with ``--engine sharded`` on the 1M-row file.
   ``python3 chip_smoke.py --only sharded`` runs phases 1 and 8 alone;
9. ``BitBirch`` and the command line's host commands, on 131,072 of the 1M
   fingerprints: (a) the native C++ engine (built here with the host
   compiler; its build seconds) at t = 0.3 and t = 0.65, fit wall, fps/s
   and cluster count, every molecule once, sampled clusters meeting the
   diameter criterion; the Python engine on the first 20,000 of those rows
   gives the native engine's labels.  It fails if a host compiler is there
   and the native engine is not the one that ran; (b) ``BatchTree`` on the
   card on the same 131,072 rows against (a)'s serial counts: both counts
   and their ratio (held to the 0.5x-1.3x band of the JAX package's test;
   the number is the finding); (c) ``global_clustering(1000,
   method="kmeans-tpu")`` on (a)'s t = 0.65 tree with no ``device=``: it
   allocates on the card, labels in 1..k, two calls with one seed equal,
   every molecule assigned; (d) ``cli.main(["run", file, "-t", "0.3"])`` with
   no ``--engine``: (a)'s count, every molecule once, ``config.json`` names
   the host engine; then ``cli.main(["multiround", dir, "-p", "4", ...])``
   over 8 files of 16,384 rows: every molecule once, sampled clusters meet
   the final round's criterion; walls from ``timings.json``.  The walls of
   (a) and (d) are the host CPU's, named beside them.
   ``python3 chip_smoke.py --only bitbirch`` runs phases 1 and 9 alone.

Each main-path run (each fit, each predict, the refine, each command-line
run) counts the kernels' launches from zero and must launch the kernels it
runs; the plain search must never see CUDA tensors.  The line before the
last is a JSON object with each kernel's launches, error, times, bound and
share at the shape the fits give it (the "fit" cases of phases 2, 2b and
2c); the last line is
``{"ok": true, "device": {...}}``.  Any failed phase raises and the script
exits non-zero without a result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

N_FPS = 1_000_000
N_FEATURES = 2048
SEED = 12620509540149709235
# Cluster counts of the JAX engine for this input (the last parsed bench),
# printed as information; the port's own deterministic counts are held
# exactly
JAX_COUNTS = {0.3: 395_183, 0.65: 983_380}
# Peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s and dense int8
# operations/s, for the kernels' bounds
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15
# Per timed case: the groups the rows are routed to and the share of rows
# pending.  "fit" is the average launch of a profiled 1M fit at t = 0.3
# (chip_profile.py): 7,408 of 8,192 rows pending on 64 groups per sorted
# launch, 515 of 2,048 on 2 groups per per-row launch
ROUTES = {"one": (1, 0.8), "few": (3, 0.8), "spread": (4095, 0.8)}
SORTED_FIT = (64, 7408 / 8192)
ROWS_FIT = (2, 515 / 2048)
PORT_COUNTS = {0.3: 397_552, 0.65: 983_222}
# Phase 7's sizes: centroids of the 1M tree that k-means clusters, its
# clusters, and the rows and iterations of the t-SNE embedding
KMEANS_ROWS = 100_000
KMEANS_K = 1000
TSNE_ROWS = 5000
TSNE_ITERS = 750
# Phase 8: cluster counts of the sharded engine on one card (the port's own,
# deterministic): one shard at the bench's settings, the command line's one
# shard, and eight shards of cuda:0 per threshold
SHARDED_COUNTS = {"one": 397_552, "cli": 397_552, 0.3: 404_913, 0.65: 976_372}
# Phase 9: rows of the 1M input that BitBirch's host engines cluster, the
# prefix of them that the Python engine clusters too, the clusters of the
# global k-means, and the files and rows a file of the multiround run
BITBIRCH_ROWS = 131_072
BITBIRCH_PY_ROWS = 20_000
GLOBAL_K = 1000
MULTIROUND_FILES = 8
# The band in which the JAX package's test holds BatchTree's count to the
# serial engine's (tests/test_batch_engine.py)
SERIAL_BAND = (0.5, 1.3)
FIT_SETTINGS = {
    0.3: dict(initial_capacity=1 << 19, ls_capacity=1 << 18),
    0.65: dict(initial_capacity=1 << 21, ls_capacity=1 << 18),
}


def say(*parts) -> None:
    print(*parts, flush=True)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; no result")
    from bblean_tpu_torch import _build
    from bblean_tpu_torch.ops import tile_search

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    t0 = time.perf_counter()
    tile_search._lib()
    built = time.perf_counter() - t0
    say(
        f"phase 1 device: {name} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | kernel build {_build.build_seconds['tile_search.cu']:.2f} s "
        f"(load {built:.2f} s)"
    )
    say(smi)
    return name


def _search_case(gen, m, g, fc, f8, route, kind=""):
    r"""Random tile tables and rows on the card; ``route`` is (groups the
    rows are routed to, share of rows pending).  ``kind``: "" (70% live
    cells, four pending rows with groups outside the table), "empty" (no
    live cell), "ties" (cells 1, 5, 9 and 200 of every tile are copies,
    most rows equal to them: the lowest cell must win), "long" (every row
    pending on group 0: items longer than ITEM_ROWS)."""
    dev = "cuda"
    t_pk = torch.randint(0, 256, (g, fc, f8), generator=gen, device=dev, dtype=torch.uint8)
    occ = torch.rand((g, fc), generator=gen, device=dev) < 0.7
    if kind == "empty":
        occ[:] = False
    if kind == "ties":
        occ[:, [1, 5, 9, 200]] = True
        t_pk[:, [5, 9, 200]] = t_pk[:, 1:2]
    occ[g - 1] = False  # the engine's guard tile holds no live cell
    t_slot = torch.where(
        occ, torch.randint(0, 1 << 20, (g, fc), generator=gen, device=dev, dtype=torch.int32), -1
    )
    t_pk[~occ] = 0
    from bblean_tpu_torch.ops.tile_search import _popcount_u8

    t_pops = _popcount_u8(t_pk).sum(-1, dtype=torch.int32)
    row_pk = torch.randint(0, 256, (m, f8), generator=gen, device=dev, dtype=torch.uint8)
    n_route, p_pending = route
    row_group = torch.randint(0, n_route, (m,), generator=gen, device=dev, dtype=torch.int32)
    pending = torch.rand(m, generator=gen, device=dev) < p_pending
    if kind == "long":
        pending[:] = True
    elif kind == "ties":
        tie = torch.rand(m, generator=gen, device=dev) < 0.7
        row_pk[tie] = t_pk[row_group[tie].long(), 1]
    else:
        # Pending rows with groups outside the table: read as JAX's gather
        # reads them (wrapped once if negative, then clamped), by kernels
        # and plain
        oob = torch.tensor([g + 7, -1, -g - 5, 1 << 30], dtype=torch.int32, device=dev)[:m]
        row_group[: len(oob)] = oob
        pending[: len(oob)] = True
    row_pop = _popcount_u8(row_pk).sum(-1, dtype=torch.int32)
    return row_pk, row_pop, row_group, t_pk, t_pops, t_slot, pending


def _median_ms(fn, reps=15) -> float:
    r"""CUDA events around one call, median of ``reps``: the wrapper's host
    dispatch is inside (the card idles while it runs)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _kernel_ms(fn, name="tile_search_kernel", reps=20) -> tuple[float, int]:
    r"""A kernel's own time on the card: mean duration of the launches of
    the kernel called ``name`` in a ``torch.profiler`` trace (CUPTI) of
    ``reps`` calls, without the host dispatch around it; returns the mean
    and the number of launches it is over.  CUPTI now and then loses an
    activity record of a kernel this short, so a trace that holds fewer
    than ``reps`` records is taken again, up to three times; the last one
    counts if it holds at least half of them.  A record too many, or a
    trace without the kernel, is an error at once."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages() if name in e.key]
        count = sum(e.count for e in kern)
        if count == reps:
            break
        if count > reps or count == 0:
            raise AssertionError(f"the profiler saw {count} launches of {name}, not {reps}")
        say(f"  profiler kept {count} of {reps} records of {name} (attempt {attempt + 1})")
    if 2 * count < reps:
        raise AssertionError(f"the profiler saw {count} launches of {name}, not {reps}")
    return sum(e.device_time_total for e in kern) / count / 1e3, count


def _bound(row_group, pending, tile_shape) -> dict:
    r"""The least time the card could take for one search, from this case's
    inputs: each distinct routed tile (cells, popcounts, slots) and each
    pending row (bits, popcount) read once, every row's group and pending
    flag read and its (sim, slot) written once, over 3.35 TB/s; each bit of
    AND + popcount of a pending row against a cell as one int8 multiply-add
    (2 operations) over 1,979 TOP/s (H100 SXM data sheet).  The int8 rate
    is a stand-in: the dense items run on the binary mma (.and.popc), for
    which no H100 peak is published, so the operations bound may be off by
    that rate's ratio to int8's."""
    m = row_group.shape[0]
    g, fc, f8 = tile_shape
    live = pending.bool()
    p = int(live.sum())
    grp = torch.where(row_group < 0, row_group + g, row_group).clamp(0, g - 1)
    tiles = int(torch.unique(grp[live]).numel())
    n_bytes = tiles * fc * (f8 + 8) + p * (f8 + 4) + m * (4 + 1 + 8)
    n_ops = 2 * p * fc * f8 * 8
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / INT8_OPS_PER_S
    return {
        "pending": p, "tiles": tiles, "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
    }


def _check_equal(got, ref, what: str) -> float:
    r"""Sims bit-equal and slots equal where a candidate exists; returns
    the largest absolute sim difference (0.0 when equal)."""
    torch.cuda.synchronize()
    if not torch.equal(got[0], ref[0]):
        raise AssertionError(f"sims differ at {what}")
    cand = ref[0] > -1.5
    if not torch.equal(got[1][cand], ref[1][cand]):
        raise AssertionError(f"slots differ at {what}")
    return float((got[0] - ref[0]).abs().max())


def _time_case(kernel, plain, bound, name="tile_search_kernel") -> dict:
    r"""Kernel time (profiler), the same call with its host dispatch
    (events), the plain version's time, and the bound with its share."""
    out = dict(bound)
    out["ms"], out["ms_over"] = _kernel_ms(kernel, name)
    out["call_ms"] = _median_ms(kernel)
    out["plain_ms"] = _median_ms(plain, reps=5)
    out["share"] = out["bound_ms"] / out["ms"]
    return out


def _timing_text(t: dict) -> str:
    work = f"{t['pending']} pending rows on {t['tiles']} tiles" if "tiles" in t else t["work"]
    return (
        f" | kernel {t['ms']:.4f} ms (profiler, mean of {t['ms_over']}; {t['call_ms']:.4f} ms "
        f"a call with dispatch, events), plain {t['plain_ms']:.4f} ms; "
        f"{work}: bound {t['bound_ms']:.4g} ms ({t['bound_by']}), share "
        f"{t['share']:.3f}"
    )


def _check_path(ts, before: int, f8: int, what: str) -> None:
    r"""F8 % 16 != 0 must take the generic path, F8 = 256 the bulk copies."""
    took = ts.generic_launches - before
    if took != (f8 % 16 != 0):
        raise AssertionError(f"{what}: {took} generic-path launches at F8={f8}")


def _tie_check(got, row_pk, row_group, t_pk, t_slot, pending, what) -> None:
    r"""Rows equal to cell 1 of their group score 1.0 there and at its copies
    5, 9 and 200: the kernel must return cell 1's slot."""
    grp = row_group.long().clamp(0, t_pk.shape[0] - 1)
    tie = pending & (row_pk == t_pk[grp, 1]).all(-1)
    if not bool(tie.any()):
        raise AssertionError(f"{what}: no tied row")
    if not (bool((got[0][tie] == 1.0).all()) and torch.equal(got[1][tie], t_slot[grp[tie], 1])):
        raise AssertionError(f"{what}: a tie did not keep the lowest cell")


def phase_kernel() -> dict:
    r"""The sorted front end against the plain version at the wide rounds'
    shapes (M = 8192, Fc = 256 and 512, F8 = 256, 33 and 13) on one, three
    and 4,095 groups and at the fit's average launch, empty tiles, tied
    cells and one group holding every row; and torch._int_mm on the
    unpacked bits as information."""
    from bblean_tpu_torch.ops import tile_search as ts

    gen = torch.Generator(device="cuda").manual_seed(7)
    g = 4096
    cases = [
        (m, fc, 256, conc, "")
        for m in (8192, 2048)
        for fc in (256, 512)
        for conc in ("one", "few", "spread")
    ] + [
        (8192, 256, 256, "fit", ""),
        (8192, 256, 256, "spread", "empty"), (2048, 64, 33, "few", ""),
        (2048, 64, 13, "few", ""), (8192, 256, 256, "few", "ties"),
        (8192, 256, 256, "one", "long"),
    ]
    max_err = 0.0
    timing = {}
    for m, fc, f8, conc, kind in cases:
        row_pk, row_pop, row_group, t_pk, t_pops, t_slot, pending = _search_case(
            gen, m, g, fc, f8, SORTED_FIT if conc == "fit" else ROUTES[conc], kind
        )
        order, skey, items = ts.sorted_search_plan(torch.where(pending, row_group, g - 1))
        srows, spops = row_pk[order], row_pop[order]

        def kernel():
            return ts.tile_search_planned(
                srows, spops, skey, order, t_pk, t_pops, t_slot, pending, items
            )

        def plain():
            return ts.search_tiles_plain(
                row_pk, row_pop, row_group, t_pk, t_pops, t_slot, pending
            )

        what = f"M={m} Fc={fc} F8={f8} {conc}{' ' + kind if kind else ''}"
        before = ts.generic_launches
        got = kernel()
        _check_path(ts, before, f8, what)
        max_err = max(max_err, _check_equal(got, plain(), what))
        if kind == "empty" and bool((got[0] > -1.5).any()):
            raise AssertionError("empty tiles produced a candidate")
        if kind == "ties":
            _tie_check(got, row_pk, row_group, t_pk, t_slot, pending, what)
        line = f"phase 2 kernel == plain: {what}"
        if m == 8192 and fc == 256 and f8 == 256 and not kind:
            timing[conc] = _time_case(kernel, plain, _bound(row_group, pending, t_pk.shape))
            line += _timing_text(timing[conc])
        say(line)
        if m == 8192 and fc == 256 and f8 == 256 and conc == "one" and not kind:
            say(_int_mm_line(row_pk, t_pk))
    return {"max_abs_err": max_err, "timing": timing}


def _int_mm_line(row_pk, t_pk) -> str:
    r"""torch._int_mm of the unpacked int8 rows (8192 x 2048) against one
    group's unpacked tile (2048 x 256): intersections only (no Tanimoto,
    no argmax, one tile for every row), so not the same function."""
    from bblean_tpu_torch.engine.batch import unpack_fingerprints_device

    f = row_pk.shape[1] * 8
    a = unpack_fingerprints_device(row_pk, f).to(torch.int8).contiguous()
    b = unpack_fingerprints_device(t_pk[0], f).to(torch.int8).contiguous().t()
    ms = _median_ms(lambda: torch._int_mm(a, b))
    return (
        f"phase 2 information: torch._int_mm {tuple(a.shape)} x {tuple(b.shape)} "
        f"int8 -> int32, intersections only: {ms:.4f} ms (events, median of 15)"
    )


def phase_row_kernel() -> dict:
    r"""The per-row front end against the plain version: the narrow rounds'
    width (2048), an unaligned width (1000), the fit's batch (8192);
    256- and 512-cell tiles; 2048-, 264- and 104-bit rows; rows on one
    group, on three, on all 4,095, and at the fit's average per-row
    launch; all-empty tiles; tied cells; a pending mask, the masked rows
    carrying out-of-range groups."""
    from bblean_tpu_torch.ops import tile_search as ts

    gen = torch.Generator(device="cuda").manual_seed(11)
    g = 4096
    cases = [
        (m, fc, f8, conc, "")
        for m in (8192, 2048, 1000)
        for fc in (256, 512)
        for f8 in (256, 33)
        for conc in ("one", "few", "spread")
    ] + [
        (2048, 256, 256, "fit", ""),
        (2048, 256, 256, "spread", "empty"), (1000, 512, 33, "few", "empty"),
        (2048, 64, 13, "few", ""), (2048, 256, 256, "few", "ties"),
    ]
    max_err = 0.0
    timing = {}
    for m, fc, f8, conc, kind in cases:
        row_pk, row_pop, row_group, t_pk, t_pops, t_slot, pending = _search_case(
            gen, m, g, fc, f8, ROWS_FIT if conc == "fit" else ROUTES[conc], kind
        )
        row_group = torch.where(pending, row_group, g + 7)

        def kernel():
            return ts.tile_search_rows(
                row_pk, row_pop, row_group, t_pk, t_pops, t_slot, pending
            )

        def plain():
            return ts.search_tiles_plain(
                row_pk, row_pop, row_group, t_pk, t_pops, t_slot, pending
            )

        what = f"M={m} Fc={fc} F8={f8} {conc}{' ' + kind if kind else ''}"
        before = ts.generic_launches
        got = kernel()
        _check_path(ts, before, f8, f"per-row {what}")
        max_err = max(max_err, _check_equal(got, plain(), f"per-row {what}"))
        if kind == "empty" and bool((got[0] > -1.5).any()):
            raise AssertionError("empty tiles produced a candidate")
        if kind == "ties":
            _tie_check(got, row_pk, row_group, t_pk, t_slot, pending, what)
        line = f"phase 2b per-row kernel == plain: {what}"
        if m == 2048 and fc == 256 and f8 == 256 and not kind:
            timing[conc] = _time_case(kernel, plain, _bound(row_group, pending, t_pk.shape))
            line += _timing_text(timing[conc])
        say(line)
    return {"max_abs_err": max_err, "timing": timing}


def phase_plan() -> dict:
    r"""The sort plan's item-table kernel against its plain version on
    sorted keys like the engine's (pending rows on their routed groups, the
    rest on the guard group 4,095): the fit's average sorted launch (7,408
    of 8,192 rows on 64 groups), one group, 4,095 groups, and predict's
    batches of 1,024 and 131,072 rows; timed on the fit's keys."""
    from bblean_tpu_torch.ops import tile_search as ts

    gen = torch.Generator(device="cuda").manual_seed(13)
    guard = 4095
    cases = [
        ("fit", 8192, SORTED_FIT), ("one", 8192, ROUTES["one"]),
        ("spread", 8192, ROUTES["spread"]), ("spread", 1024, (guard, 1.0)),
        ("spread", 131_072, (guard, 1.0)),
    ]
    timing = {}
    for conc, m, (n_route, p_pending) in cases:
        group = torch.randint(0, n_route, (m,), generator=gen, device="cuda", dtype=torch.int32)
        pending = torch.rand(m, generator=gen, device="cuda") < p_pending
        skey = torch.sort(torch.where(pending, group, guard), stable=True).values

        def kernel():
            return ts.plan_items(skey)

        def plain():
            return ts.plan_items_plain(skey)

        got = kernel()
        ref = plain()
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            raise AssertionError(f"plan item tables differ at M={m} {conc}")
        line = f"phase 2c plan kernel == plain: M={m} {conc}, {int(got[m])} items"
        if conc == "fit":
            n_bytes = 4 * m + 4 * (m + 1)  # keys read, table written
            timing[conc] = _time_case(kernel, plain, {
                "work": f"{m} keys in, {m + 1} entries out",
                "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            }, name="plan_items_kernel")
            line += _timing_text(timing[conc])
        say(line)
    return {"max_abs_err": 0.0, "timing": timing}


def _reset_counts() -> None:
    from bblean_tpu_torch.ops import tile_search as ts

    ts.launches = 0
    ts.row_launches = 0
    ts.generic_launches = 0
    ts.plan_launches = 0


def _counts() -> tuple[int, int, int]:
    from bblean_tpu_torch.ops import tile_search as ts

    return ts.launches, ts.row_launches, ts.plan_launches


def phase_cpu_vs_cuda() -> None:
    from bblean_tpu_torch.fingerprints import make_fake_fingerprints
    from bblean_tpu_torch import BatchTree

    fps = make_fake_fingerprints(20_000, N_FEATURES, seed=SEED)
    queries = make_fake_fingerprints(2_000, N_FEATURES, seed=1)
    out = {}
    for device in ("cpu", "cuda"):
        t0 = time.perf_counter()
        tree = BatchTree(N_FEATURES, threshold=0.3, batch_size=1024, device=device)
        tree.fit_packed(fps, range(len(fps)))
        fit_labels, n_fit = tree.assignments(), tree.num_clusters
        t1 = time.perf_counter()
        tree.recluster_inplace(shuffle=True, seed=7)
        recl_labels, n_recl = tree.assignments(), tree.num_clusters
        tree.refine_inplace(fps, n_largest=2)
        t2 = time.perf_counter()
        out[device] = [fit_labels, recl_labels, tree.assignments()]
        for batch in (1024, 1000):
            out[device] += list(tree.predict_packed(queries, batch=batch))
        say(
            f"phase 3 {device}: 20k fps t=0.3 -> {n_fit} clusters in "
            f"{t1 - t0:.2f} s; recluster -> {n_recl}, refine -> "
            f"{tree.num_clusters} in {t2 - t1:.2f} s; predict of 2,000 at "
            f"batch 1024 and 1000 in {time.perf_counter() - t2:.2f} s"
        )
    names = [
        "fit labels", "recluster labels", "refine labels", "predict slots (1024)",
        "predict sims (1024)", "predict slots (1000)", "predict sims (1000)",
    ]
    for name, a, b in zip(names, out["cpu"], out["cuda"]):
        if not np.array_equal(a, b):
            raise AssertionError(f"CPU and CUDA {name} differ at {int((a != b).sum())} rows")
    for a, b in ((out["cuda"][3], out["cuda"][5]), (out["cuda"][4], out["cuda"][6])):
        if not np.array_equal(a, b):
            raise AssertionError("predict differs between batch 1024 and 1000")
    say(
        "phase 3 CPU and CUDA identical: fit, recluster and refine labels, "
        "predicted slots and sims at batch 1024 and 1000"
    )


def _members_by_cluster(labels: np.ndarray, n_clusters: int):
    order = np.argsort(labels, kind="stable")
    bounds = np.searchsorted(labels[order], np.arange(n_clusters + 1))
    return lambda c: order[bounds[c] : bounds[c + 1]]


def _check_assigned_once(tree) -> tuple[np.ndarray, np.ndarray]:
    return _check_labels(tree.assignments(), tree.cluster_sizes())


def _check_labels(labels, sizes, n: int = N_FPS) -> tuple[np.ndarray, np.ndarray]:
    if labels.shape != (n,) or (labels < 0).any():
        raise AssertionError("not every molecule was assigned")
    if int(sizes.sum()) != n:
        raise AssertionError(f"cluster sizes sum to {int(sizes.sum())}")
    if not np.array_equal(np.bincount(labels, minlength=len(sizes)), sizes):
        raise AssertionError("assignments disagree with cluster sizes")
    return labels, sizes


def _check_cohesion(labels, sizes, fps: np.ndarray, threshold: float) -> tuple[int, float]:
    r"""1,000 sampled multi-member clusters meet the diameter criterion in
    float64; returns (clusters checked, smallest iSIM)."""
    from bblean_tpu_torch.fingerprints import jt_isim_from_sum

    multi = np.flatnonzero(sizes >= 2)
    rng = np.random.default_rng(0)
    pick = rng.choice(multi, size=min(1000, len(multi)), replace=False)
    members_of = _members_by_cluster(labels, len(sizes))
    worst = np.inf
    for c in pick:
        members = members_of(c)
        ls = np.unpackbits(fps[members], axis=1).sum(0, dtype=np.uint64)
        worst = min(worst, jt_isim_from_sum(ls, len(members)))
    if worst < threshold - 1e-6:
        raise AssertionError(f"a sampled cluster has iSIM {worst} < {threshold}")
    return len(pick), float(worst)


def _check_fit(tree, fps: np.ndarray, threshold: float) -> None:
    labels, sizes = _check_assigned_once(tree)
    n, worst = _check_cohesion(labels, sizes, fps, threshold)
    say(
        f"phase 4 t={threshold}: all {N_FPS} molecules assigned once; "
        f"{n} sampled multi-member clusters meet the diameter "
        f"criterion (min float64 iSIM {worst:.6f})"
    )


class _PlainOnCuda:
    r"""Counts calls of the plain search on CUDA tensors (it must see none)
    while installed in place of ``tile_search.search_tiles_plain``, through
    which both wrappers reach the plain version."""

    def __init__(self) -> None:
        from bblean_tpu_torch.ops import tile_search as ts

        self.ts, self.plain, self.calls = ts, ts.search_tiles_plain, 0

    def __call__(self, row_pk, *args):
        self.calls += row_pk.device.type == "cuda"
        return self.plain(row_pk, *args)

    def __enter__(self):
        self.ts.search_tiles_plain = self
        return self

    def __exit__(self, *exc) -> None:
        self.ts.search_tiles_plain = self.plain

    def check(self, what: str) -> None:
        if self.calls:
            raise AssertionError(f"the plain search ran on CUDA tensors during {what}")


def phase_full_size() -> dict:
    from bblean_tpu_torch.fingerprints import make_fake_fingerprints
    from bblean_tpu_torch import BatchTree
    from bblean_tpu_torch.engine import batch as engine

    t0 = time.perf_counter()
    fps = make_fake_fingerprints(N_FPS, N_FEATURES, seed=SEED)
    dev_fps = torch.from_numpy(fps).to("cuda")
    torch.cuda.synchronize()
    say(f"phase 4 input: {N_FPS} x {N_FEATURES}-bit fps staged on the card in {time.perf_counter() - t0:.1f} s")

    launches = {"sorted": 0, "rows": 0, "plan": 0}
    kept = None
    fit_walls = {}
    with _PlainOnCuda() as plain:
        for thr in (0.3, 0.65):
            torch.cuda.reset_peak_memory_stats()
            syncs0 = engine.host_syncs
            _reset_counts()
            t0 = time.perf_counter()
            tree = BatchTree(
                N_FEATURES, threshold=thr, batch_size=8192, device="cuda",
                **FIT_SETTINGS[thr],
            )
            tree.fit_packed(dev_fps, range(N_FPS))
            ncl = tree.num_clusters
            torch.cuda.synchronize()
            wall = fit_walls[thr] = time.perf_counter() - t0
            n_sorted, n_rows, n_plan = _counts()
            launches["sorted"] += n_sorted
            launches["rows"] += n_rows
            launches["plan"] += n_plan
            from bblean_tpu_torch.ops import tile_search as ts

            n_generic = ts.generic_launches
            syncs = engine.host_syncs - syncs0
            rel = (ncl - JAX_COUNTS[thr]) / JAX_COUNTS[thr]
            say(
                f"phase 4 t={thr}: fit {wall:.2f} s, {N_FPS / wall:.0f} fps/s, "
                f"{ncl} clusters (port's count {PORT_COUNTS[thr]}; JAX record "
                f"{JAX_COUNTS[thr]}, rel diff {rel:+.5%}), {syncs} host syncs, "
                f"kernel launches {n_sorted} sorted + {n_rows} per-row "
                f"({n_generic} on the generic path) + {n_plan} plan, peak "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated"
            )
            if n_sorted <= 0 or n_plan <= 0:
                raise AssertionError("the fit never launched the sorted search or the plan kernel")
            if n_generic:
                raise AssertionError(f"the fit took the generic path {n_generic} times")
            plain.check("the fit")
            if ncl != PORT_COUNTS[thr]:
                raise AssertionError(f"cluster count {ncl} is not the port's {PORT_COUNTS[thr]}")
            _check_fit(tree, fps, thr)
            if thr == 0.3:
                kept = tree
            else:
                del tree
                torch.cuda.empty_cache()
        if launches["rows"] <= 0:
            raise AssertionError("the two fits never launched the per-row tile-search kernel")
        del dev_fps
        phase5, centroids = phase_predict_refine(kept, fps, plain)
        del kept
        torch.cuda.empty_cache()
        phase6 = phase_cli(fps, fit_walls, plain)
        phase8 = phase_sharded(fps, plain)
        phase9 = phase_bitbirch(fps, plain)
    phase_side_ops(centroids)
    return {
        "launches": {
            k: launches[k] + phase5[k] + phase6[k] + phase8[k] + phase9[k]
            for k in launches
        },
    }


def _time_predict_searches(tree, queries: np.ndarray) -> dict:
    r"""Both searches at the same batch sizes on the tree's own tables, with
    the groups predict routes the queries to: the sorted search (its
    in-call sort and gathers included) and the per-row search, identical
    results, CUDA events, median of 15.  Predict picks between them by the
    TPU engine's alignment rule; these times say where the crossover lies
    on the card."""
    from bblean_tpu_torch.engine import batch as engine
    from bblean_tpu_torch.ops import tile_search as ts

    st = tree.state
    out = {}
    for m in (1000, 1024, 8192):
        packed = torch.from_numpy(queries[:m]).to("cuda")
        bits = engine.unpack_fingerprints_device(packed, tree.n_features)
        row_pop = bits.sum(-1, dtype=torch.int32)
        valid = torch.ones(m, dtype=torch.bool, device="cuda")
        row_group = engine._route_groups(
            bits.to(torch.int8), row_pop, st.g_cent, st.g_pops, tree.num_groups,
            valid, tree.route_block,
        )
        args = (packed, row_pop, row_group, st.t_pk, st.t_pops, st.t_slot, valid)

        def srt():
            return ts.tile_search_sorted(*args, guard_group=st.g_ls.shape[0] - 1)

        def rows():
            return ts.tile_search_rows(*args)

        _check_equal(rows(), srt(), f"the predict searches at M={m}")
        out[m] = (_median_ms(srt), _median_ms(rows))
        say(
            f"phase 5 predict searches at M={m} on the 1M tree: sorted "
            f"{out[m][0]:.4f} ms, per-row {out[m][1]:.4f} ms (median of 15), "
            f"identical"
        )
    return out


def phase_predict_refine(tree, fps: np.ndarray, plain: _PlainOnCuda) -> tuple[dict, np.ndarray]:
    r"""Phase 5 on the t = 0.3 tree: predict through both kernels, then a
    refine of the largest cluster.  Returns the launches and the tree's
    first ``KMEANS_ROWS`` packed centroids (phase 7's input)."""
    from bblean_tpu_torch.engine import batch as engine

    queries = fps[:131_072]
    launches = {"sorted": 0, "rows": 0, "plan": 0}
    pred = {}
    for batch, kernel in ((8192, "sorted"), (1000, "rows")):
        _reset_counts()
        t0 = time.perf_counter()
        pred[batch] = tree.predict_packed(queries, batch=batch)
        wall = time.perf_counter() - t0
        n_sorted, n_rows, n_plan = _counts()
        launches["sorted"] += n_sorted
        launches["rows"] += n_rows
        launches["plan"] += n_plan
        say(
            f"phase 5 predict {len(queries)} queries at batch {batch}: "
            f"{wall:.3f} s, {len(queries) / wall:.0f} queries/s, kernel "
            f"launches {n_sorted} sorted + {n_rows} per-row + {n_plan} plan"
        )
        if (min(n_sorted, n_plan), n_rows)[kernel == "rows"] <= 0:
            raise AssertionError(f"predict at batch {batch} never launched the {kernel} kernel")
        plain.check("predict")
    slots, sims = pred[8192]
    if not (np.array_equal(slots, pred[1000][0]) and np.array_equal(sims, pred[1000][1])):
        raise AssertionError("predict differs between the sorted and the per-row kernel")
    n_cl = tree.num_clusters
    if (slots < 0).any() or (slots >= n_cl).any():
        raise AssertionError("predict returned a slot outside the tree")
    cents = tree.packed_centroids()
    kmeans_input = cents[:KMEANS_ROWS].copy()
    pick = np.random.default_rng(1).choice(len(queries), size=1000, replace=False)
    q_bits = np.unpackbits(queries[pick], axis=1).astype(np.int64)
    c_bits = np.unpackbits(cents[slots[pick]], axis=1).astype(np.int64)
    inter = (q_bits & c_bits).sum(1)
    union = q_bits.sum(1) + c_bits.sum(1) - inter
    ref = inter / np.maximum(union, 1)
    err = float(np.abs(sims[pick] - ref).max())
    if err > 1e-6:
        raise AssertionError(f"predicted sims are {err} off the float64 Tanimoto")
    say(
        f"phase 5 predict: sorted and per-row kernels identical; 1000 sampled "
        f"sims within {err:.2e} of the float64 Tanimoto to their centroid"
    )
    del cents, q_bits, c_bits
    _time_predict_searches(tree, queries)

    torch.cuda.reset_peak_memory_stats()
    syncs0 = engine.host_syncs
    _reset_counts()
    t0 = time.perf_counter()
    tree.refine_inplace(fps, n_largest=1)
    ncl = tree.num_clusters
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_sorted, n_rows, n_plan = _counts()
    launches["sorted"] += n_sorted
    launches["rows"] += n_rows
    launches["plan"] += n_plan
    plain.check("the refine")
    say(
        f"phase 5 refine (n_largest=1): {wall:.2f} s, {n_cl} -> {ncl} clusters, "
        f"{engine.host_syncs - syncs0} host syncs, kernel launches {n_sorted} "
        f"sorted + {n_rows} per-row + {n_plan} plan, pool_dead_rows "
        f"{tree.pool_dead_rows}, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated"
    )
    if n_sorted <= 0 or n_plan <= 0:
        raise AssertionError("the refine never launched the sorted search or the plan kernel")
    labels, sizes = _check_assigned_once(tree)
    ls = tree.linear_sums()
    members_of = _members_by_cluster(labels, len(sizes))
    multi = np.flatnonzero(sizes >= 2)
    rng = np.random.default_rng(2)
    pick = rng.choice(multi, size=min(200, len(multi)), replace=False)
    for c in pick:
        bits = np.unpackbits(fps[members_of(c)], axis=1).sum(0, dtype=np.int64)
        if not np.array_equal(bits, ls[c]):
            raise AssertionError(f"cluster {c}'s linear sum is not its members' bits")
    del ls
    n, worst = _check_cohesion(labels, sizes, fps, tree.threshold)
    say(
        f"phase 5 refine: all {N_FPS} molecules assigned once; {len(pick)} "
        f"sampled linear sums equal their members' bits; {n} sampled "
        f"multi-member clusters meet the diameter criterion (min float64 "
        f"iSIM {worst:.6f})"
    )
    return launches, kmeans_input


def _staging_alone(path, batch: int = 8192) -> float:
    r"""Wall of reading the mapped file and staging it onto the card as
    ``fit_packed`` does (chunks of ``stage_windows`` x ``scan_batches``
    batches), with nothing else: what the host input adds to a fit."""
    from bblean_tpu_torch import BatchTree

    probe = BatchTree(N_FEATURES, batch_size=batch, device="cuda")
    chunk_rows = probe.stage_windows * probe.scan_batches * batch
    del probe
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = np.load(path, mmap_mode="r")
    with warnings.catch_warnings():
        # A read-only mapped file gives a tensor that is only read
        warnings.filterwarnings("ignore", message="The given NumPy array is not writable")
        for start in range(0, len(rows), chunk_rows):
            chunk = np.ascontiguousarray(rows[start : start + chunk_rows], np.uint8)
            torch.from_numpy(chunk).to("cuda")
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _check_run_dir(out_dir, fps: np.ndarray, threshold: float, what: str, phase: int = 6) -> dict:
    r"""The run directory's invariants: every molecule id once, sizes
    non-increasing, as many clusters as ``config.json`` says, 1,000 sampled
    clusters meeting the diameter criterion in float64, 200 sampled stored
    centroids equal to their members' majority vote."""
    import pickle

    from bblean_tpu_torch.fingerprints import jt_isim_from_sum

    with open(out_dir / "clusters.pkl", "rb") as f:
        clusters = pickle.load(f)
    with open(out_dir / "cluster-centroids-packed.pkl", "rb") as f:
        cents = pickle.load(f)
    config = json.loads((out_dir / "config.json").read_text())
    timings = json.loads((out_dir / "timings.json").read_text())
    sizes = np.fromiter((len(c) for c in clusters), np.int64, len(clusters))
    flat = np.concatenate([np.asarray(c, np.int64) for c in clusters])
    if len(flat) != len(fps) or not np.array_equal(np.sort(flat), np.arange(len(fps))):
        raise AssertionError(f"{what}: clusters.pkl does not hold every molecule once")
    if (np.diff(sizes) > 0).any():
        raise AssertionError(f"{what}: clusters are not sorted by size")
    # The host commands (exact engine, multiround) record no n_clusters
    n_clusters = config.get("n_clusters", len(clusters))
    if not len(clusters) == len(cents) == n_clusters:
        raise AssertionError(
            f"{what}: {len(clusters)} clusters, {len(cents)} centroids, "
            f"n_clusters {n_clusters}"
        )
    if not (out_dir / "input-fps").is_dir():
        raise AssertionError(f"{what}: no input-fps directory")
    rng = np.random.default_rng(3)
    multi = np.flatnonzero(sizes >= 2)
    worst = np.inf
    for c in rng.choice(multi, size=min(1000, len(multi)), replace=False):
        ls = np.unpackbits(fps[clusters[c]], axis=1).sum(0, dtype=np.uint64)
        worst = min(worst, jt_isim_from_sum(ls, len(clusters[c])))
    if worst < threshold - 1e-6:
        raise AssertionError(f"{what}: a sampled cluster has iSIM {worst} < {threshold}")
    # Half of the sampled centroids from the multi-member clusters
    pick = np.concatenate([
        rng.choice(multi, size=min(100, len(multi)), replace=False),
        rng.choice(len(clusters), size=100, replace=False),
    ])
    for c in pick:
        bits = np.unpackbits(fps[clusters[c]], axis=1).sum(0, dtype=np.int64)
        vote = np.packbits(bits >= len(clusters[c]) * 0.5)
        if not np.array_equal(vote, cents[c]):
            raise AssertionError(f"{what}: cluster {c}'s stored centroid is not its majority vote")
    say(
        f"phase {phase} {what}: all {len(fps)} molecules once in {len(clusters)} clusters "
        f"sorted by size (largest {int(sizes[0])}); 1000 sampled clusters meet the "
        f"diameter criterion (min float64 iSIM {worst:.6f}); {len(pick)} sampled "
        f"stored centroids equal their members' majority vote"
    )
    return {"n_clusters": len(clusters), "timings": timings, "config": config}


def phase_cli(fps: np.ndarray, fit_walls: dict, plain: "_PlainOnCuda") -> dict:
    r"""Phase 6: the port's command line from ``.npy`` files to pickles."""
    import tempfile
    from pathlib import Path

    from bblean_tpu_torch.cli import main as cli_main
    from bblean_tpu_torch.fingerprints import make_fake_fingerprints
    from bblean_tpu_torch.ops import tile_search as ts

    launches = {"sorted": 0, "rows": 0, "plan": 0}
    with tempfile.TemporaryDirectory(prefix="bb-smoke-") as tmp:
        tmp = Path(tmp)
        one = tmp / "one" / "fps.npy"
        two = tmp / "two"
        one.parent.mkdir()
        two.mkdir()
        t0 = time.perf_counter()
        np.save(one, fps)
        half = 3 * N_FPS // 5  # an uneven cut, inside a scan window
        np.save(two / "part0.npy", fps[:half])
        np.save(two / "part1.npy", fps[half:])
        say(f"phase 6 input: 1M fps written to one file and to two ({half} + {N_FPS - half} rows) in {time.perf_counter() - t0:.1f} s")
        staging = _staging_alone(one)
        say(
            f"phase 6 reading and staging alone (mapped file to the card in "
            f"fit_packed's chunks, page cache warm): {staging:.3f} s"
        )
        runs = [
            ("a: one file, t=0.3", one, 0.3, []),
            ("b: two files, t=0.3, --refine-num 1", two, 0.3, ["--refine-num", "1"]),
            ("c: one file, t=0.65", one, 0.65, []),
        ]
        for what, input_, thr, extra in runs:
            out_dir = tmp / f"out-{what[0]}"
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            _reset_counts()
            t0 = time.perf_counter()
            cli_main([
                "run", str(input_), "-o", str(out_dir), "-t", str(thr),
                "--engine", "batch", "--no-monitor-mem", "-V", *extra,
            ])
            wall = time.perf_counter() - t0
            n_sorted, n_rows, n_plan = _counts()
            launches["sorted"] += n_sorted
            launches["rows"] += n_rows
            launches["plan"] += n_plan
            if min(n_sorted, n_rows, n_plan) <= 0 or ts.generic_launches:
                raise AssertionError(
                    f"phase 6 {what}: kernel launches {n_sorted} sorted + {n_rows} "
                    f"per-row + {n_plan} plan, {ts.generic_launches} generic"
                )
            plain.check(f"the command line ({what})")
            got = _check_run_dir(out_dir, fps, thr, what)
            t = got["timings"]
            peak = got["config"]["device_memory"]["peak_bytes_in_use"]
            parts = ", ".join(f"{k} {v:.2f} s" for k, v in t.items() if k != "total")
            say(
                f"phase 6 {what}: {got['n_clusters']} clusters (resident fit of phase 4: "
                f"{PORT_COUNTS[thr]}); total {t['total']:.2f} s of {wall:.2f} s in "
                f"main(): {parts}; resident-input fit of phase 4 {fit_walls[thr]:.2f} s; "
                f"kernel launches {n_sorted} sorted + {n_rows} per-row + {n_plan} plan "
                f"(0 generic); peak {peak / 2**30:.2f} GiB allocated; device "
                f"{got['config']['device']} {got['config']['accelerators']}"
            )
            if not extra and thr == 0.3:
                rel = (got["n_clusters"] - PORT_COUNTS[thr]) / PORT_COUNTS[thr]
                say(f"phase 6 a: count against the resident fit's: rel diff {rel:+.5%}")

        small = tmp / "small.npy"
        np.save(small, make_fake_fingerprints(20_000, N_FEATURES, seed=SEED))
        files = {}
        for device in ("cpu", "cuda"):
            out_dir = tmp / f"out-d-{device}"
            t0 = time.perf_counter()
            cli_main([
                "run", str(small), "-o", str(out_dir), "-t", "0.3", "--engine", "batch",
                "--batch-size", "1024", "--no-monitor-mem", "-V", "--device", device,
            ])
            files[device] = [
                (out_dir / name).read_bytes()
                for name in ("clusters.pkl", "cluster-centroids-packed.pkl")
            ]
            say(f"phase 6 d: 20k fps through the command line on {device} in {time.perf_counter() - t0:.2f} s")
        if files["cpu"] != files["cuda"]:
            raise AssertionError("phase 6 d: CPU and CUDA runs wrote different pickles")
        say("phase 6 d: clusters.pkl and cluster-centroids-packed.pkl byte-equal on CPU and CUDA")
    return launches


class _MergeSearchCheck:
    r"""While installed, holds sampled launches of both tile-search front
    ends, as the engine's step makes them, bit-equal to the plain version on
    the same inputs (the first three launches of each front end after
    ``arm()`` and every 25th after).  The wrapper's own launch is the main
    path's; the plain version runs beside it and launches no kernel."""

    def __init__(self, plain: "_PlainOnCuda") -> None:
        from bblean_tpu_torch.engine import batch as engine

        self.engine, self.plain = engine, plain.plain
        self.planned, self.rows = engine.tile_search_planned, engine.tile_search_rows
        self.armed = False
        self.seen = {"sorted": 0, "rows": 0}
        self.checked = {"sorted": 0, "rows": 0}
        self.work = {"sorted": [], "rows": []}

    def arm(self, on: bool) -> None:
        self.armed = on
        self.seen = {"sorted": 0, "rows": 0}

    def _due(self, kind: str) -> bool:
        self.seen[kind] += 1
        return self.armed and (self.seen[kind] <= 3 or self.seen[kind] % 25 == 0)

    def _hold(self, kind, got, row_pk, row_pop, row_group, t_pk, t_pops, t_slot, pending):
        ref = self.plain(row_pk, row_pop, row_group, t_pk, t_pops, t_slot, pending)
        _check_equal(got, ref, f"a {kind} launch inside the merge")
        self.checked[kind] += 1
        b = _bound(row_group, pending, t_pk.shape)
        self.work[kind].append((b["pending"], b["tiles"], row_pk.shape[0]))

    def _planned(self, srows, spops, skey, order, t_pk, t_pops, t_slot, pending, items):
        got = self.planned(srows, spops, skey, order, t_pk, t_pops, t_slot, pending, items)
        if self._due("sorted"):
            # Undo the plan's sort: the plain version takes rows in place
            row_pk, row_pop = torch.empty_like(srows), torch.empty_like(spops)
            row_group = torch.empty_like(skey)
            row_pk[order], row_pop[order], row_group[order] = srows, spops, skey
            self._hold("sorted", got, row_pk, row_pop, row_group, t_pk, t_pops, t_slot, pending)
        return got

    def _rows(self, row_pk, row_pop, row_group, t_pk, t_pops, t_slot, pending):
        got = self.rows(row_pk, row_pop, row_group, t_pk, t_pops, t_slot, pending)
        if self._due("rows"):
            self._hold("rows", got, row_pk, row_pop, row_group, t_pk, t_pops, t_slot, pending)
        return got

    def __enter__(self):
        self.engine.tile_search_planned = self._planned
        self.engine.tile_search_rows = self._rows
        return self

    def __exit__(self, *exc) -> None:
        self.engine.tile_search_planned = self.planned
        self.engine.tile_search_rows = self.rows


def _sharded_run(dev_fps, mesh, threshold, check=None, **kw):
    r"""One sharded fit + merge on the card: the forest, the walls and the
    kernels' launches of the fit and of the merge (counted from zero)."""
    from bblean_tpu_torch.engine import batch as engine
    from bblean_tpu_torch.ops import tile_search as ts
    from bblean_tpu_torch.parallel import ShardedForest

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    syncs0 = engine.host_syncs
    _reset_counts()
    t0 = time.perf_counter()
    forest = ShardedForest(N_FEATURES, mesh, threshold=threshold, batch_size=8192, **kw)
    forest.fit_packed(dev_fps)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    fit_counts = _counts()
    fit_peak = torch.cuda.max_memory_allocated()
    if check is not None:
        check.arm(True)
    forest.merge()
    ncl = forest.num_clusters
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    if check is not None:
        check.arm(False)
    merge_counts = tuple(b - a for a, b in zip(fit_counts, _counts()))
    if ts.generic_launches:
        raise AssertionError(f"the sharded run took the generic path {ts.generic_launches} times")
    return forest, {
        "fit_s": t1 - t0, "merge_s": t2 - t1, "n_clusters": ncl,
        "fit_launches": fit_counts, "merge_launches": merge_counts,
        "syncs": engine.host_syncs - syncs0, "fit_peak": fit_peak,
        "peak": torch.cuda.max_memory_allocated(),
    }


def _launch_text(counts) -> str:
    return f"{counts[0]} sorted + {counts[1]} per-row + {counts[2]} plan"


def _check_forest(forest, fps: np.ndarray, what: str) -> np.ndarray:
    r"""Phase 8's gates on a merged forest; returns the labels."""
    from bblean_tpu_torch.engine import batch as engine

    labels, sizes = _check_labels(forest.labels(), forest.cluster_sizes())
    members_of = _members_by_cluster(labels, len(sizes))
    multi = np.flatnonzero(sizes >= 2)
    pick = np.random.default_rng(2).choice(multi, size=min(200, len(multi)), replace=False)
    state = forest.states[0]
    ls = engine._cluster_ls_of(
        state, torch.from_numpy(pick).to(state.n.device), N_FEATURES
    ).cpu().numpy()
    for row, c in zip(ls, pick):
        bits = np.unpackbits(fps[members_of(c)], axis=1).sum(0, dtype=np.int64)
        if not np.array_equal(bits, row):
            raise AssertionError(f"{what}: cluster {c}'s linear sum is not its members' bits")
    n, worst = _check_cohesion(labels, sizes, fps, forest.merge_threshold)
    say(
        f"phase 8 {what}: all {N_FPS} molecules labelled once, sizes equal the label "
        f"histogram; {len(pick)} sampled linear sums equal their members' bits; {n} "
        f"sampled multi-member clusters meet the diameter criterion at the merge "
        f"threshold (min float64 iSIM {worst:.6f})"
    )
    return labels


def _held_count(key, ncl: int, what: str) -> None:
    if ncl != SHARDED_COUNTS[key]:
        raise AssertionError(f"{what}: {ncl} clusters, not the port's {SHARDED_COUNTS[key]}")


def phase_sharded(fps: np.ndarray, plain: "_PlainOnCuda") -> dict:
    r"""Phase 8: the sharded engine with every shard on ``cuda:0``."""
    import tempfile
    from pathlib import Path

    from bblean_tpu_torch.cli import main as cli_main
    from bblean_tpu_torch.fingerprints import make_fake_fingerprints
    from bblean_tpu_torch.ops import tile_search as ts
    from bblean_tpu_torch.parallel import get_mesh, sharded_fit

    launches = {"sorted": 0, "rows": 0, "plan": 0}

    def add(counts) -> None:
        for k, c in zip(("sorted", "rows", "plan"), counts):
            launches[k] += c

    dev_fps = torch.from_numpy(fps).to("cuda:0")

    # (a) one shard at the bench's settings
    forest, r = _sharded_run(
        dev_fps, get_mesh(devices=["cuda:0"]), 0.3,
        initial_capacity=1 << 19, ls_capacity=1 << 18,
    )
    add(r["fit_launches"])
    add(r["merge_launches"])
    plain.check("the one-shard fit")
    wall = r["fit_s"] + r["merge_s"]
    say(
        f"phase 8 a: 1 shard, t=0.3: fit + merge {wall:.2f} s ({N_FPS / wall:.0f} fps/s; "
        f"merge {r['merge_s']:.3f} s), {r['n_clusters']} clusters (BatchTree: "
        f"{PORT_COUNTS[0.3]}), {r['syncs']} host syncs, kernel launches "
        f"{_launch_text(r['fit_launches'])} (0 generic), {forest.growths} table growths, "
        f"peak {r['peak'] / 2**30:.2f} GiB allocated"
    )
    if min(r["fit_launches"]) <= 0:
        raise AssertionError("the one-shard fit did not launch every kernel")
    _held_count("one", r["n_clusters"], "phase 8 a")
    count_a = r["n_clusters"]
    del forest

    # (b) eight shards on the one card, twice per threshold, and (d) inside
    # their merges
    mesh8 = get_mesh(devices=["cuda:0"] * 8)
    for thr in (0.3, 0.65):
        # The command line's capacity rule for 1M rows on eight shards
        cap = (N_FPS // 8) * 2 + 2 * 8192
        first = None
        for run in (1, 2):
            with _MergeSearchCheck(plain) as check:
                forest, r = _sharded_run(dev_fps, mesh8, thr, check, initial_capacity=cap)
            add(r["fit_launches"])
            add(r["merge_launches"])
            plain.check("the eight-shard fit and merge")
            wall = r["fit_s"] + r["merge_s"]
            say(
                f"phase 8 b: 8 shards on cuda:0, t={thr}, run {run}: fit {r['fit_s']:.2f} s, "
                f"merge {r['merge_s']:.2f} s ({r['merge_s'] / wall:.1%} of {wall:.2f} s; "
                f"{N_FPS / wall:.0f} fps/s), {r['n_clusters']} clusters, {r['syncs']} host "
                f"syncs, kernel launches: fit {_launch_text(r['fit_launches'])}, merge "
                f"{_launch_text(r['merge_launches'])} (0 generic), {forest.growths} table "
                f"growths, capacities {forest.capacity} slots / {forest.g_capacity} groups "
                f"/ {forest.ls_capacity} pool rows, peak {r['fit_peak'] / 2**30:.2f} GiB "
                f"in the fit, {r['peak'] / 2**30:.2f} GiB in all"
            )
            for stats in forest.merge_stats:
                per = stats["receivers"]
                say(
                    f"phase 8 b: t={thr} run {run} merge round stride {stats['stride']}: "
                    f"received groups far {sum(s['far'] for s in per.values())} / close "
                    f"{sum(s['close'] for s in per.values())}, rows inserted row-level "
                    f"{sum(s['rows'] for s in per.values())} ({len(per)} receivers), "
                    f"{stats['retries']} retries, {stats['growths']} growths"
                )
            if min(r["fit_launches"]) <= 0:
                raise AssertionError("the eight-shard fit did not launch every kernel")
            rows_in = sum(
                s["rows"] for st in forest.merge_stats for s in st["receivers"].values()
            )
            if rows_in and min(r["merge_launches"][0], r["merge_launches"][2]) <= 0:
                raise AssertionError("the merge inserted rows and launched no sorted search")
            if rows_in and min(check.checked.values()) <= 0:
                raise AssertionError(f"phase 8 d: checked {check.checked} launches in the merge")
            say(
                f"phase 8 d: t={thr} run {run}: inside the merge {check.checked['sorted']} "
                f"sorted and {check.checked['rows']} per-row launches == plain on the "
                f"merge's inputs (pending rows, tiles, M of the first three: sorted "
                f"{check.work['sorted'][:3]}, per-row {check.work['rows'][:3]})"
            )
            _held_count(thr, r["n_clusters"], f"phase 8 b t={thr}")
            if run == 1:
                first = _check_forest(forest, fps, f"b: t={thr}")
            elif not np.array_equal(first, forest.labels()):
                raise AssertionError(f"phase 8 b: two runs at t={thr} gave different labels")
            else:
                say(f"phase 8 b: t={thr}: two runs gave identical labels")
            del forest
    del dev_fps
    torch.cuda.empty_cache()

    # (c) CPU shards against shards of the card
    small = make_fake_fingerprints(20_000, N_FEATURES, seed=SEED)
    res = {}
    for device in ("cpu", "cuda:0"):
        t0 = time.perf_counter()
        res[device] = sharded_fit(
            small, get_mesh(devices=[device] * 4), input_is_packed=True,
            threshold=0.3, batch_size=1024, centroid_block=1024,
        )
        say(
            f"phase 8 c: 20k fps on 4 shards of {device}: {res[device].num_clusters} "
            f"clusters in {time.perf_counter() - t0:.2f} s"
        )
    if not (
        np.array_equal(res["cpu"].labels, res["cuda:0"].labels)
        and np.array_equal(res["cpu"].sizes, res["cuda:0"].sizes)
    ):
        raise AssertionError("phase 8 c: CPU and CUDA shards gave different labels")
    say("phase 8 c: CPU and CUDA shards gave identical labels and sizes")

    # (e) the command line
    with tempfile.TemporaryDirectory(prefix="bb-smoke-") as tmp:
        tmp = Path(tmp)
        np.save(tmp / "fps.npy", fps)
        out_dir = tmp / "out"
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.perf_counter()
        cli_main([
            "run", str(tmp / "fps.npy"), "-o", str(out_dir), "-t", "0.3",
            "--engine", "sharded", "--no-monitor-mem", "-V",
        ])
        wall = time.perf_counter() - t0
        add(_counts())
        if min(_counts()) <= 0 or ts.generic_launches:
            raise AssertionError(
                f"phase 8 e: kernel launches {_launch_text(_counts())}, "
                f"{ts.generic_launches} generic"
            )
        plain.check("the command line (--engine sharded)")
        got = _check_run_dir(out_dir, fps, 0.3, "e: --engine sharded, one file, t=0.3", 8)
        cfg, t = got["config"], got["timings"]
        parts = ", ".join(f"{k} {v:.2f} s" for k, v in t.items() if k != "total")
        say(
            f"phase 8 e: {got['n_clusters']} clusters (one shard of a: {count_a}); "
            f"{cfg['n_devices']} device(s), {cfg['device_table_bytes_per_device'] / 2**30:.2f} "
            f"GiB of tables per shard; total {t['total']:.2f} s of {wall:.2f} s in main(): "
            f"{parts}; kernel launches {_launch_text(_counts())} (0 generic)"
        )
        if cfg["n_devices"] != torch.cuda.device_count():
            raise AssertionError("phase 8 e: the mesh is not every visible card")
        _held_count("cli", got["n_clusters"], "phase 8 e")
    return launches


def _host_cpu() -> str:
    from bblean_tpu_torch.utils import _cpu_name, _num_avail_cpus

    return f"host CPU {_cpu_name()!r}, {_num_avail_cpus()} cores"


def _exact_fit(rows: np.ndarray, threshold: float, python: bool = False):
    r"""``BitBirch.fit`` at the command line's branching factor, on the
    native engine or (``python``) with the extensions switched off; returns
    (tree, wall seconds)."""
    from bblean_tpu_torch import BitBirch
    from bblean_tpu_torch._config import DEFAULTS

    switch = "BBLEAN_TPU_NO_EXTENSIONS"
    before = os.environ.pop(switch, None)
    if python:
        os.environ[switch] = "1"
    try:
        t0 = time.perf_counter()
        tree = BitBirch(
            threshold=threshold, branching_factor=DEFAULTS.branching_factor
        ).fit(rows)
        wall = time.perf_counter() - t0
    finally:
        os.environ.pop(switch, None)
        if before is not None:
            os.environ[switch] = before
    return tree, wall


def _check_exact_tree(tree, rows: np.ndarray, threshold: float, what: str) -> int:
    r"""Every molecule once, sizes non-increasing, and 1,000 sampled
    clusters meeting the diameter criterion; returns the cluster count."""
    labels = tree.get_assignments().astype(np.int64) - 1
    ids = tree.get_cluster_mol_ids()
    sizes = np.fromiter((len(c) for c in ids), np.int64, len(ids))
    _check_labels(labels, sizes, len(rows))
    if (np.diff(sizes) > 0).any():
        raise AssertionError(f"{what}: clusters are not sorted by size")
    n, worst = _check_cohesion(labels, sizes, rows, threshold)
    say(
        f"phase 9 {what}: all {len(rows)} molecules once in {len(ids)} clusters; "
        f"{n} sampled multi-member clusters meet the diameter criterion "
        f"(min float64 iSIM {worst:.6f})"
    )
    return len(ids)


def phase_bitbirch(fps: np.ndarray, plain: "_PlainOnCuda") -> dict:
    r"""Phase 9: ``BitBirch`` on both host engines, ``BatchTree`` against the
    serial count, the global k-means on the card, and the command line's
    ``run`` (default engine) and ``multiround``."""
    import tempfile
    from pathlib import Path

    from bblean_tpu_torch import BatchTree, _build, _native
    from bblean_tpu_torch.cli import main as cli_main
    from bblean_tpu_torch.ops import tile_search as ts

    t_phase = time.perf_counter()
    rows = np.ascontiguousarray(fps[:BITBIRCH_ROWS])
    cpu = _host_cpu()

    # (a) both host engines
    try:
        compiler = _build._find_cxx()
    except _build.CompilerNotFound:
        compiler = None
    t0 = time.perf_counter()
    native_ok = _native.available()  # builds the library; a failed build raises
    say(
        f"phase 9 a native library: compiler {compiler}, built in "
        f"{_build.build_seconds.get('bblean_native.cpp', 0.0):.2f} s "
        f"(build + load {time.perf_counter() - t0:.2f} s) -> {_native.loaded_lib_path()}"
    )
    if compiler is not None and not native_ok:
        raise AssertionError("a host compiler is there and the native library did not load")
    engine = "native" if native_ok else "python"
    serial_counts, trees = {}, {}
    for thr in (0.3, 0.65):
        tree, wall = _exact_fit(rows, thr)
        if tree.engine_name != engine:
            raise AssertionError(f"phase 9 a: the {tree.engine_name} engine ran, not {engine}")
        ncl = _check_exact_tree(tree, rows, thr, f"a t={thr} {engine} engine")
        serial_counts[thr], trees[thr] = ncl, tree
        say(
            f"phase 9 a t={thr}: BitBirch.fit ({engine} engine) of {BITBIRCH_ROWS} rows "
            f"{wall:.2f} s, {BITBIRCH_ROWS / wall:.0f} fps/s, {ncl} clusters ({cpu})"
        )
        small = rows[:BITBIRCH_PY_ROWS]
        py_tree, py_wall = _exact_fit(small, thr, python=True)
        nat_tree, nat_wall = _exact_fit(small, thr)
        if py_tree.engine_name != "python" or nat_tree.engine_name != engine:
            raise AssertionError("phase 9 a: the switch did not select the engines")
        if not np.array_equal(py_tree.get_assignments(), nat_tree.get_assignments()):
            raise AssertionError(f"phase 9 a t={thr}: the two engines' labels differ")
        if py_tree.get_cluster_mol_ids() != nat_tree.get_cluster_mol_ids():
            raise AssertionError(f"phase 9 a t={thr}: the two engines' clusters differ")
        say(
            f"phase 9 a t={thr}: Python engine on the first {BITBIRCH_PY_ROWS} rows "
            f"{py_wall:.2f} s ({BITBIRCH_PY_ROWS / py_wall:.0f} fps/s), {engine} engine "
            f"{nat_wall:.2f} s ({BITBIRCH_PY_ROWS / nat_wall:.0f} fps/s): identical labels, "
            f"{len(py_tree.get_cluster_mol_ids())} clusters"
        )
    # The host's clock spreads (its cores are shared): the first fit once more
    again, wall = _exact_fit(rows, 0.3)
    if len(again.get_cluster_mol_ids()) != serial_counts[0.3]:
        raise AssertionError("phase 9 a: a second fit gave another count")
    say(
        f"phase 9 a t=0.3 once more: {wall:.2f} s, {BITBIRCH_ROWS / wall:.0f} fps/s, "
        f"the same {serial_counts[0.3]} clusters"
    )
    del again

    # (b) BatchTree on the card against the serial counts
    launches = {"sorted": 0, "rows": 0, "plan": 0}
    outside_band = []
    dev_rows = torch.from_numpy(rows).to("cuda")
    for thr in (0.3, 0.65):
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tree = BatchTree(
            N_FEATURES, threshold=thr, batch_size=8192, device="cuda",
            initial_capacity=1 << 18,
        )
        tree.fit_packed(dev_rows, range(BITBIRCH_ROWS))
        ncl = tree.num_clusters
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_sorted, n_rows, n_plan = _counts()
        launches["sorted"] += n_sorted
        launches["rows"] += n_rows
        launches["plan"] += n_plan
        if n_sorted <= 0 or n_plan <= 0 or ts.generic_launches:
            raise AssertionError(
                f"phase 9 b t={thr}: launches {n_sorted} sorted + {n_plan} plan, "
                f"{ts.generic_launches} generic"
            )
        plain.check("phase 9 b")
        labels, sizes = _check_labels(tree.assignments(), tree.cluster_sizes(), BITBIRCH_ROWS)
        _check_cohesion(labels, sizes, rows, thr)
        ratio = ncl / serial_counts[thr]
        say(
            f"phase 9 b t={thr}: BatchTree {ncl} clusters in {wall:.2f} s on the card "
            f"against the serial {engine} engine's {serial_counts[thr]}: ratio "
            f"{ratio:.6f} (band {SERIAL_BAND[0]}-{SERIAL_BAND[1]}); launches {n_sorted} "
            f"sorted + {n_rows} per-row + {n_plan} plan"
        )
        if not SERIAL_BAND[0] <= ratio <= SERIAL_BAND[1]:
            outside_band.append(f"t={thr}: ratio {ratio:.6f} outside {SERIAL_BAND}")
        del tree
    del dev_rows
    torch.cuda.empty_cache()

    # (c) the global k-means on the card, on the t = 0.65 tree's centroids
    tree = trees[0.65]
    runs = []
    for _ in range(2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        allocs = torch.cuda.memory_stats()["allocation.all.allocated"]
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # "experimental feature"
            tree.global_clustering(GLOBAL_K, method="kmeans-tpu", seed=0)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        new_allocs = torch.cuda.memory_stats()["allocation.all.allocated"] - allocs
        centroid_bytes = serial_counts[0.65] * N_FEATURES * 4
        if new_allocs <= 0 or peak < centroid_bytes:
            raise AssertionError(
                f"phase 9 c: the k-means did not work on the card ({new_allocs} "
                f"allocations, peak {peak} B < the centroids' {centroid_bytes} B)"
            )
        centroid_labels = np.asarray(tree._global_clustering_centroid_labels)
        labels = tree.get_assignments(global_clusters=True)
        if centroid_labels.min() < 1 or centroid_labels.max() > GLOBAL_K:
            raise AssertionError("phase 9 c: a centroid's label is outside 1..k")
        if labels.shape != (BITBIRCH_ROWS,) or labels.min() < 1 or labels.max() > GLOBAL_K:
            raise AssertionError("phase 9 c: not every molecule got a global label in 1..k")
        runs.append((centroid_labels, wall, peak))
    if not np.array_equal(runs[0][0], runs[1][0]):
        raise AssertionError("phase 9 c: two calls with one seed differ")
    say(
        f"phase 9 c: global_clustering({GLOBAL_K}, method='kmeans-tpu') of "
        f"{serial_counts[0.65]} centroids on {torch.cuda.get_device_name(0)}: "
        f"{runs[0][1]:.2f} s, {runs[1][1]:.2f} s (centroids off the tree and onto the "
        f"card included), {len(np.unique(runs[0][0]))} labels used, peak "
        f"{runs[1][2] / 2**30:.2f} GiB allocated on the card; two calls identical; "
        f"all {BITBIRCH_ROWS} molecules labelled in 1..{GLOBAL_K}"
    )
    del trees, tree

    # (d) the command line's host commands
    with tempfile.TemporaryDirectory(prefix="bb-smoke-") as tmp:
        tmp = Path(tmp)
        np.save(tmp / "fps.npy", rows)
        shards = tmp / "shards"
        shards.mkdir()
        per_file = BITBIRCH_ROWS // MULTIROUND_FILES
        for i in range(MULTIROUND_FILES):
            np.save(shards / f"fps.{i:02d}.npy", rows[i * per_file : (i + 1) * per_file])
        _reset_counts()
        t0 = time.perf_counter()
        cli_main([
            "run", str(tmp / "fps.npy"), "-o", str(tmp / "out-run"), "-t", "0.3",
            "--no-monitor-mem", "-V",
        ])
        wall = time.perf_counter() - t0
        got = _check_run_dir(tmp / "out-run", rows, 0.3, "d: run, default engine", phase=9)
        cfg = got["config"]
        if cfg["engine"] != "exact" or cfg["host_engine"] != engine or "device" in cfg:
            raise AssertionError(f"phase 9 d: config.json says {cfg}")
        if cfg["native_extensions_enabled"] != native_ok:
            raise AssertionError("phase 9 d: config.json's native_extensions_enabled is wrong")
        if got["n_clusters"] != serial_counts[0.3]:
            raise AssertionError(
                f"phase 9 d: the run's {got['n_clusters']} clusters are not "
                f"BitBirch.fit's {serial_counts[0.3]}"
            )
        say(
            f"phase 9 d run (no --engine): {got['n_clusters']} clusters (= phase 9 a), "
            f"host engine {cfg['host_engine']}; total {got['timings']['total']:.2f} s of "
            f"{wall:.2f} s in main() (the rest: extraction and pickles) ({cpu})"
        )
        # What a worker process of multiround's pool costs before it works:
        # the fork server's start (it imports the package, and so torch,
        # once) and a worker forked from it
        import multiprocessing as mp

        ctx = mp.get_context("forkserver")
        ctx.set_forkserver_preload(["bblean_tpu_torch.multiround"])
        starts = []
        for _ in range(2):
            t0 = time.perf_counter()
            with ctx.Pool(processes=1) as pool:
                pool.apply(os.getpid)
            starts.append(time.perf_counter() - t0)
        say(
            f"phase 9 d pool of one worker: {starts[0]:.2f} s with the fork server's "
            f"start, {starts[1]:.2f} s from the running server"
        )
        t0 = time.perf_counter()
        cli_main([
            "multiround", str(shards), "-o", str(tmp / "out-multiround"), "-t", "0.3",
            "-p", "4", "--no-monitor-mem", "-V",
        ])
        wall = time.perf_counter() - t0
        # The final round merges by tolerance-diameter at the same threshold:
        # every cluster it leaves has an iSIM of at least the threshold
        got = _check_run_dir(
            tmp / "out-multiround", rows, 0.3, "d: multiround, 8 files, 4 processes", phase=9,
        )
        cfg = got["config"]
        if cfg["host_engine"] != engine or cfg["final_merge_criterion"] is not None:
            raise AssertionError(f"phase 9 d: multiround's config.json says {cfg}")
        parts = ", ".join(f"{k} {v:.2f} s" for k, v in got["timings"].items() if k != "total")
        say(
            f"phase 9 d multiround ({MULTIROUND_FILES} files of {per_file} rows, 4 "
            f"processes): {got['n_clusters']} clusters, host engine {cfg['host_engine']}; "
            f"total {got['timings']['total']:.2f} s of {wall:.2f} s in main(): {parts} ({cpu})"
        )
        if sum(_counts()) != 0:
            raise AssertionError("phase 9 d: a host command launched a device kernel")
    say(f"phase 9 took {time.perf_counter() - t_phase:.1f} s")
    if outside_band:
        raise AssertionError("phase 9 b: " + "; ".join(outside_band))
    return launches


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _inertia(x: torch.Tensor, labels: np.ndarray, k: int) -> float:
    r"""Sum of squared distances to the clusters' means, float64 on the card."""
    lab = torch.from_numpy(labels).to(x.device)
    x64 = x.to(torch.float64)
    sums = torch.zeros((k, x.shape[1]), dtype=torch.float64, device=x.device)
    sums.index_add_(0, lab, x64)
    counts = torch.bincount(lab, minlength=k).clamp_min(1).to(torch.float64)
    return float(((x64 - (sums / counts[:, None])[lab]) ** 2).sum())


def phase_side_ops(packed_centroids: np.ndarray) -> None:
    r"""Phase 7: popcount, Tanimoto, k-means and t-SNE on the card, each
    against the same function on the CPU."""
    from bblean_tpu_torch.ops import kmeans, popcount, tanimoto, tsne

    rows, cents = packed_centroids[:8192], packed_centroids[8192 : 8192 + 1024]
    row_bits, cent_bits = np.unpackbits(rows, axis=1), np.unpackbits(cents, axis=1)
    checks = {
        "popcount_device": lambda d: popcount.popcount_device(rows, device=d),
        "popcount_rows": lambda d: popcount.popcount_rows(row_bits, device=d),
        "tanimoto_packed_arr_vec": lambda d: tanimoto.tanimoto_packed_arr_vec(rows, cents[0], device=d),
        "intersection_matmul": lambda d: tanimoto.intersection_matmul(row_bits, cent_bits, device=d),
        "tanimoto_matmul": lambda d: tanimoto.tanimoto_matmul(row_bits, cent_bits, device=d),
    }
    for name, fn in checks.items():
        fn("cuda")
        got, wall = _timed(lambda: fn("cuda"))
        if got.device.type != "cuda" or not torch.equal(got.cpu(), fn("cpu")):
            raise AssertionError(f"phase 7: {name} differs between CPU and CUDA")
        say(f"phase 7 {name}: 8192 x 2048 bits (against 1024 centroids) equal on CPU and CUDA; {wall * 1e3:.3f} ms with the upload")

    k = KMEANS_K
    x = np.unpackbits(packed_centroids, axis=1).astype(np.float32)
    labels, wall = _timed(lambda: kmeans.kmeans_fit_predict(x, k, seed=0))
    again, wall2 = _timed(lambda: kmeans.kmeans_fit_predict(x, k, seed=0))
    if not np.array_equal(labels, again):
        raise AssertionError("phase 7: two k-means calls with one seed differ")
    if labels.shape != (len(x),) or labels.min() < 0 or labels.max() >= k:
        raise AssertionError("phase 7: k-means labels out of range")
    dev_x = torch.from_numpy(x).to("cuda")
    inertia = _inertia(dev_x, labels, k)
    chance = _inertia(dev_x, np.random.default_rng(0).integers(0, k, len(x)), k)
    say(
        f"phase 7 k-means: {len(x)} x 2048 centroids into {k} clusters, 50 iterations: "
        f"{wall:.2f} s and {wall2:.2f} s, two calls equal, "
        f"{len(np.unique(labels))} clusters used, inertia {inertia:.6g} "
        f"(random labels: {chance:.6g})"
    )
    if not inertia < chance:
        raise AssertionError("phase 7: k-means is no better than random labels")
    sub, k_sub = x[:10_000], 100
    on_card = kmeans.kmeans_fit_predict(sub, k_sub, seed=0)
    on_cpu, cpu_wall = _timed(lambda: kmeans.kmeans_fit_predict(sub, k_sub, seed=0, device="cpu"))
    i_card = _inertia(dev_x[:10_000], on_card, k_sub)
    i_cpu = _inertia(dev_x[:10_000], on_cpu, k_sub)
    same = float((on_card == on_cpu).mean())
    say(
        f"phase 7 k-means CPU against CUDA (10,000 rows, {k_sub} clusters, one seed, the "
        f"same draws): {same:.4%} of labels equal, inertia {i_card:.6g} on the card, "
        f"{i_cpu:.6g} on the CPU ({cpu_wall:.2f} s)"
    )
    if abs(i_card - i_cpu) > 0.01 * i_cpu:
        raise AssertionError("phase 7: k-means inertia differs by more than 1% between CPU and CUDA")
    del dev_x

    pts = x[:TSNE_ROWS]
    emb, wall = _timed(lambda: tsne.tsne_embed(pts, n_iter=TSNE_ITERS))
    if emb.shape != (TSNE_ROWS, 2) or not np.isfinite(emb).all():
        raise AssertionError("phase 7: t-SNE output is not a finite (rows, 2) array")
    say(
        f"phase 7 t-SNE: {TSNE_ROWS} x 2048 rows, {TSNE_ITERS} iterations (host PCA init included): "
        f"{wall:.2f} s, finite, spread {emb.std(0)[0]:.3f} x {emb.std(0)[1]:.3f}"
    )
    small = pts[:2000]
    line = []
    for n_iter in (5, 10, 20):
        a = tsne.tsne_embed(small, n_iter=n_iter)
        b = tsne.tsne_embed(small, n_iter=n_iter, device="cpu")
        rel = float(np.abs(a - b).max() / np.abs(b).max())
        line.append(f"{n_iter} iterations {rel:.2e}")
        if n_iter == 5 and rel > 1e-3:
            raise AssertionError(f"phase 7: t-SNE after 5 iterations is {rel} of its scale off the CPU's")
    say(
        "phase 7 t-SNE CPU against CUDA (2,000 rows), largest difference over the "
        "embedding's scale: " + ", ".join(line) + " (held to 1e-3 at 5; the descent "
        "amplifies rounding, the faster the more rows, so 10 and 20 are information)"
    )


def _kernel_record(name, replaces, launches, phase) -> dict:
    r"""One kernel's entry of the JSON line: times, bound and share at the
    "fit" case, the shape of the fit's average launch."""
    t = phase["timing"]["fit"]
    return {
        "name": name,
        "route": "cuda",
        "source": "bblean_tpu_torch/csrc/tile_search.cu",
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": phase["max_abs_err"],
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "share": t["share"],
        "library_ms": None,  # no PyTorch call computes either function
    }


def _only_sharded() -> None:
    r"""Phases 1 and 8 alone (no kernels line, no result line)."""
    from bblean_tpu_torch.fingerprints import make_fake_fingerprints

    phase_device()
    fps = make_fake_fingerprints(N_FPS, N_FEATURES, seed=SEED)
    with _PlainOnCuda() as plain:
        say("phase 8 launches:", phase_sharded(fps, plain))


def _only_bitbirch() -> None:
    r"""Phases 1 and 9 alone (no kernels line, no result line)."""
    from bblean_tpu_torch.fingerprints import make_fake_fingerprints

    phase_device()
    # The first rows of the 1M input are a function of the whole draw
    fps = make_fake_fingerprints(N_FPS, N_FEATURES, seed=SEED)[:BITBIRCH_ROWS]
    with _PlainOnCuda() as plain:
        say("phase 9 launches:", phase_bitbirch(fps, plain))


def main() -> None:
    if sys.argv[1:] == ["--only", "sharded"]:
        return _only_sharded()
    if sys.argv[1:] == ["--only", "bitbirch"]:
        return _only_bitbirch()
    kind = phase_device()
    kern = phase_kernel()
    rows = phase_row_kernel()
    plan = phase_plan()
    phase_cpu_vs_cuda()
    full = phase_full_size()
    say(json.dumps({"kernels": [
        _kernel_record(
            "tile_search_sorted", "bblean_tpu/ops/pallas_search2.py:61",
            full["launches"]["sorted"], kern,
        ),
        _kernel_record(
            "tile_search_rows", "bblean_tpu/ops/pallas_search.py:42",
            full["launches"]["rows"], rows,
        ),
        _kernel_record(
            "sorted_search_plan_items", "bblean_tpu/ops/pallas_search2.py:245",
            full["launches"]["plan"], plan,
        ),
    ]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
