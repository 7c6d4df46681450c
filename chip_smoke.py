r"""Smoke run of the PyTorch port on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``.  It needs one CUDA
device and ``nvcc``, imports no JAX, and prints one line per phase as soon
as the phase ends:

1. device: the card's name and power limit (then the line
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
   prints); build the tile-search and route kernels (one ``nvcc`` for
   each source, both at once);
2. the tile-search kernel's sorted front end against its plain PyTorch
   version on the card, at the batch engine's shapes and at tied cells,
   items longer than the plan's 64 rows, 512-cell tiles and 104- and
   264-bit rows (the generic path, counted apart); sims bit-equal, slots
   equal where a candidate exists.  For rows on one, three and 4,095
   groups, and at the fit's average launch (7,408 of 8,192 rows pending on
   64 groups, from ``chip_profile.py``), each with 256- and with 512-cell
   tiles (the 10M configuration's): the kernel's time (profiler) and
   its time per call with the host dispatch (events), the plain version's
   time, and the bound computed from the case's pending rows and distinct
   tiles, with what bounds it and the kernel's share of it;
   ``torch._int_mm`` of the unpacked bits, as information (intersections
   only, not the same function);
2b. the per-row front end against the same plain version, at the narrow
   rounds' and predict's shapes, with the same times and bounds at 256- and
   512-cell tiles (the fit's average per-row launch: 515 of 2,048 rows
   pending on 2 groups);
2c. the sort plan's item-table kernel against its plain version, at the
   fit's and predict's batches, timed on the fit's keys;
2d. the route kernels (``ops/route.py`` over ``csrc/route.cu``), both
   epilogues (the route's first argmax, the merge's best sim) bit-equal to
   their plain versions: 8,192 x 2048-bit rows against 65,536 groups at
   1; 1,000; 17,364; 43,008 and 65,536 live, at the 1M fit's average
   route and at the 10M fits' average (22,000), tied centroids in other
   blocks and ranges, a block that does not divide the table (the clamped
   last block starts at 65,000, on no tile boundary), 264-bit rows (the
   generic path, counted), the merge's shape (the receivers' group
   capacity of phase 8 b), and a near tie (8192-bit rows: two centroids
   whose exact fractions differ but round to one f32, the larger at the
   later column, which must not win); every other case on the TMA path,
   counted; each 2048-bit case at the engine's block of 1,024 with the
   kernel's time (profiler), its time per call (events), the plain
   version's time, ``torch._int_mm`` over the same live blocks (the
   product alone, the library yardstick), the bound and the share;
2e. the prefix-commit kernel (``ops/prefix_commit.py`` over
   ``csrc/prefix_commit.cu``) bit-equal to its plain version, moments and
   accept masks, for the round's three calls and all six criteria
   (:func:`phase_prefix_commit`), and the look-back's stress cases;
2f. the leader-election kernel (``ops/leader_election.py`` over
   ``csrc/leader_election.cu``) bit-equal to its plain version on the rows
   its contract covers (leads on every row, the best leader of each
   rejected row that does not lead) in every layout of
   ``ELECTION_LAYOUTS`` at 8,192 and 2,048 rows (the first batch's single
   group of every row, a t = 0.3-like spread of groups, the fit's mid-fit
   wide round, ties, rows struck twice, no rejected row), as a wide round
   calls it (the step's sort plan) and as a narrow round does (its rows a
   selection of a step four times as wide, through that step's plan), and
   on ``REPLAYS`` replays of a captured call (:func:`phase_election`);
2g. the pool and tile writes' kernel (``ops/commit_writes.py`` over
   ``csrc/commit_writes.cu``) bit-equal to its plain version, every table,
   in every layout of ``WRITES_LAYOUTS`` at 8,192 and 2,048 rows (merge
   segments of thousands of rows, the vote's edge, writes past capacity,
   the guard row, rows read packed and as int32 sums in one segment) and
   on ``REPLAYS`` replays of a captured call
   (:func:`phase_writes`); 2e-2g timed as 2d is, over copies of their
   inputs taken in turn (4x the L2);
2h. the step's refresh kernel (``ops/refresh.py`` over
   ``csrc/refresh.cu``) bit-equal to its plain version, every table, in
   every layout of ``REFRESH_LAYOUTS`` (one hot group, groups of one row,
   pool clusters and singletons, overflow groups, no committed row, the
   guard slot, the vote's edges) at 8,192 rows of 2048 bits with tiles of
   256 and 512 cells and at 264 and 100 bits, each call twice (the
   kernel's scratch is left cleared), timed as 2g is
   (:func:`phase_refresh`); after phase 4, the 1M fits at t = 0.3 and
   t = 0.65 again with sampled refresh calls held to the plain version,
   the counts exact, and a mid-fit step's call timed
   (:func:`phase_refresh_fit`).
   ``python3 chip_smoke.py --only kernels`` runs phases 1 and 2-2h alone;
   ``python3 chip_smoke.py --only refresh`` runs phases 1 and 2h alone;
3. the port on the CPU (plain search) and on the card (kernels) give the
   same labels for 20,000 fingerprints after the fit, a shuffled
   recluster and a refine, and the same predicted slots and sims for
   2,000 queries at an aligned and an unaligned batch size;
4. the fit path at full size: 1M x 2048-bit fingerprints at t = 0.3 and
   t = 0.65 through ``BatchTree.fit_packed``, no launch on the kernel's
   generic path, every molecule assigned once,
   sampled clusters meeting the diameter criterion in float64, and the
   cluster counts exactly the port's own (397,552 and 983,222; their
   distance to the JAX engine's record is printed as information); each
   fit's insert rounds and split passes run as CUDA graphs
   (``engine/graphs.py``): its line prints the programs run dispatched at
   their first use, captured and replayed, the host syncs and the peak
   memory beside the peak before the rounds were graphed, and in the
   t = 0.3 fit one sampled replay of a wide round and one of a narrow
   round are held bit-equal (every output and table) to the same round
   dispatched on a clone of the state, whose calls of the prefix commits,
   the leader election and the pool and tile writes are then held to
   their plain versions and timed (the kernels line's records), with the
   fit's first election (the first batch: every row on one group);
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
   bit-equal to the plain version on the merge's own inputs, launches
   inside replayed graphs included (the capture notes the search's inputs
   and outputs, a sampled replay's tile tables are copied before it); (e) the
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
   ``python3 chip_smoke.py --only bitbirch`` runs phases 1 and 9 alone;
10. the analysis side on phase 6's run directory (a) (1M rows, t = 0.3):
   ``cli.main(["summary", dir, "--top", "20", "--chi", "--dbi", "--dunn",
   "--dump-metrics", csv])`` prints 1,000,000 fingerprints and 397,552
   clusters; ``plotting.pca_embedding`` of the top 20 clusters (193,964
   rows) and ``plotting.tsne_embedding`` (750 iterations on the card) of
   the first 1,000 rows of each (the exact t-SNE's (N, N) matrices of all
   of them would be 140 GiB each), finite and of their row counts, with
   walls and the card's peak memory; the t-SNE on the card against the CPU
   after 5 iterations, to phase 7's 1e-3 of the embedding's scale, on the
   first 100 rows of each; ``plot-tsne`` exits 1 naming matplotlib
   where matplotlib is not installed (else it writes the PNG),
   ``fps-from-smiles`` exits 1 naming RDKit where RDKit is not installed,
   and ``--version`` prints the installed version (or exits 1 saying the
   distribution is not installed).  ``python3 chip_smoke.py --only
   analysis`` runs phase 1, the command line's run (a) and phase 10 alone;
11. the four examples (``bblean_tpu_torch/examples/``) as subprocesses
   from a temporary directory, at their full sizes, the five runs below at
   once, each with its wall: ``quickstart``, ``best_practices`` and
   ``dataset_splitting`` (the host engines) print exactly what the JAX
   scripts print;
   ``multi_device --shards 8`` on ``cuda:0`` prints the JAX script's lines
   on its eight virtual CPU devices (8,565 clusters, worst iSIM 0.300), and
   ``multi_device`` on its default mesh (one shard per visible card) gives
   ``BatchTree``'s count on the same rows and settings, fitted here; both
   ``multi_device`` runs must launch the tile-search kernels.  ``python3
   chip_smoke.py --only examples`` runs phases 1 and 11 alone.

Each main-path run (each fit, each predict, the refine, each command-line
run, each merge) counts the kernels' launches from zero and must launch the
kernels it runs (the route in every fit, predict, refine and command-line
run, the route's twin in every merge of phase 8 b, the prefix commits, the
leader election and the pool and tile writes wherever rows are inserted;
none on a generic path, every route and twin launch on the TMA path);
no plain version may see CUDA tensors.  Phase 4's
fits and phase 8 b's fits and merges hold sampled launches of the route
and twin bit-equal to the plain versions on their own inputs and print
their average shapes.  The line before the last is a JSON object with each
of the nine kernels' launches, error, times, bound, share and library
yardstick at the shape the fits give it (the "fit" cases of phases 2, 2b,
2c and 2d; the merge case of 2d for the twin; a wide round of phase 4's
t = 0.3 fit for the prefix commits, the leader election and the writes;
a mid-fit step of the t = 0.3 fit for the step's refresh); the last line is
``{"ok": true, "device": {...}}``.  Any failed phase raises and the script
exits non-zero without a result.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
import warnings
import weakref
from pathlib import Path

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
# H100 SXM L2 (data sheet): a timing whose inputs fit in it reads them
# from there, not from HBM
L2_BYTES = 50 * 2**20
INT8_OPS_PER_S = 1.979e15
# Per timed case: the groups the rows are routed to and the share of rows
# pending.  "fit" is the average launch of a profiled 1M fit at t = 0.3
# (chip_profile.py): 7,408 of 8,192 rows pending on 64 groups per sorted
# launch, 515 of 2,048 on 2 groups per per-row launch
ROUTES = {"one": (1, 0.8), "few": (3, 0.8), "spread": (4095, 0.8)}
SORTED_FIT = (64, 7408 / 8192)
ROWS_FIT = (2, 515 / 2048)
PORT_COUNTS = {0.3: 397_552, 0.65: 983_222}
# Phase 2d: the route's rows and bits, its table of 65,536 groups and the
# live groups of the timed cases (17,364 and 43,008: about the 10M fits'
# final groups); "fit" is the average live groups of a route in the 1M
# fit at t = 0.3 (1,645.5 over its 123 routes; phase 4 prints it); the
# merge's receivers in phase 8 b at t = 0.3 have a group capacity of
# MERGE_Q (the twin's rows and table) and MERGE_FIT live groups a call on
# average (754.6 over 7 calls; phase 8 b prints both)
ROUTE_M = 8192
ROUTE_G_CAP = 1 << 16
ROUTE_BLOCK = 1024
ROUTE_LIVE = (1, 1000, 17_364, 43_008, 65_536)
ROUTE_FIT = 1_646
# The 10M fits' average live groups a route (about 22,000 over t = 0.65's
# 1,221 routes, from 0 to 43,298)
ROUTE_10M_AVG = 22_000
# Phase 2d's near tie: rows of 8192 bits (unions up to 8192, where two
# distinct Tanimoto fractions can share an f32), its table, and the columns
# of the smaller and of the larger exact fraction (same tile; other ranges)
NEAR_TIE_F = 8192
NEAR_TIE_G_CAP = 4096
NEAR_TIE_COLS = ((10, 20), (100, 3900))
# The kernels of one call of the route's TMA path, as the profiler names
# them: the product and the ranges' combination
ROUTE_KERNELS = ("route_wgmma_kernel", "route_combine_kernel")
MERGE_Q = 16_384
# Phase 2e: the layouts of one round's segments (``prefix_commit_case``)
PREFIX_LAYOUTS = ("singletons", "one segment", "mixed", "t=0.3 runs", "none accepted")
# Its merge thresholds: about the median cohesion of its cases' merges
# (iSIM about 0.58, the radius complement about 0.73), so that both
# outcomes occur; the tolerance is the engine's default
PREFIX_THRESHOLD = {"radius": 0.73, "tolerance-radius": 0.73}
PREFIX_DEFAULT_THRESHOLD = 0.58
PREFIX_TOLERANCE = 0.05
# Its shapes (the wide and the narrow rounds' rows at 2048 bits) and the
# kernel of one call as the profiler names it (one launch a call)
PREFIX_SHAPES = ((8192, 2048), (2048, 2048))
PREFIX_KERNELS = ("prefix_commit_kernel",)
# The look-back's stress cases (``prefix_lookback_case``), at a row count
# that is not a multiple of the chunk (16 rows on the card), each launched
# PREFIX_STRESS_LAUNCHES times and replayed PREFIX_STRESS_REPLAYS times from
# a CUDA graph
PREFIX_STRESS = (
    "one segment", "chunk-aligned segments", "long stretches without need",
    "zero stretches", "screen stretches",
)
PREFIX_STRESS_M = 8187
PREFIX_STRESS_LAUNCHES = 50
PREFIX_STRESS_REPLAYS = 20
MERGE_FIT = 755
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
# Phase 11: what the JAX package's examples print (JAX on the CPU; the
# multi_device script on 8 virtual devices), line for line
EXAMPLE_LINES = {
    "quickstart": [
        "fingerprints: (20000, 256) packed uint8 (5 MB)",
        "7859 clusters; largest [76, 66, 65, 61, 60]",
        "singletons: 7218 (92%)",
        "largest cluster iSIM: 0.306",
        "after refinement: 7185 clusters",
        "wrote assignments.csv, tree.pkl",
    ],
    "best_practices": [
        "    t  clusters   >=10    top iSIM(top)",
        " 0.20         1      1  10000     0.235",
        " 0.30      3931    257     57     0.313",
        " 0.40      7189     71    268     0.400",
        " 0.50      8841     21    238     0.500",
        " 0.65      9817      7     33     0.651",
        "",
        "t=0.3: CHI=84.36 DBI=0.04 (top-20 clusters)",
        "after refining 10 largest: 3578 clusters, top [1081 1078 1033]",
    ],
    "dataset_splitting": [
        "train 24000 / test 6000 (20.0%)",
        "max train-similarity of test mols: median 0.374 (random split: 0.409)",
        "X_train (24000, 256), y_train (24000,)",
    ],
    "multi_device": [
        "8565 clusters over 20000 rows",
        "largest: [688, 581, 572, 546, 475]",
        "worst multi-member cluster iSIM: 0.300 (threshold 0.30)",
    ],
}
# The multi_device example's data and settings, for BatchTree's count
MULTI_DEVICE_FIT = dict(rows=20_000, seed=3, threshold=0.3, batch_size=512)
FIT_SETTINGS = {
    0.3: dict(initial_capacity=1 << 19, ls_capacity=1 << 18),
    0.65: dict(initial_capacity=1 << 21, ls_capacity=1 << 18),
}


def say(*parts) -> None:
    print(*parts, flush=True)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; no result")
    from concurrent.futures import ThreadPoolExecutor

    from bblean_tpu_torch import _build
    from bblean_tpu_torch.ops import (
        commit_writes, leader_election, prefix_commit, route, tile_search,
    )

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    # One nvcc for each source, all started together
    t0 = time.perf_counter()
    kernels = (tile_search, route, prefix_commit, leader_election, commit_writes)
    with ThreadPoolExecutor(len(kernels)) as pool:
        for built in [pool.submit(m.kernel.lib) for m in kernels]:
            built.result()
    built = time.perf_counter() - t0
    secs = ", ".join(
        f"{src} {_build.build_seconds[src]:.2f} s"
        for src in (
            "tile_search.cu", "route.cu", "prefix_commit.cu", "leader_election.cu",
            "commit_writes.cu",
        )
    )
    say(
        f"phase 1 device: {name} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | kernel builds: {secs} (all, loaded: {built:.2f} s)"
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


def _kernel_ms(fn, name="tile_search_kernel", reps=20, parts: dict | None = None) -> tuple[float, int]:
    r"""A kernel's own time on the card: mean duration of the launches of
    the kernel called ``name`` in a ``torch.profiler`` trace (CUPTI) of
    ``reps`` calls, without the host dispatch around it; returns the mean
    and the number of launches it is over.  ``name`` may be a tuple: a
    call that launches one kernel of each name (the route's product and
    its ranges' combination) takes the sum of their means, over the fewest
    records any of them kept.  CUPTI now and then loses an activity record
    of a kernel this short, so a trace that holds fewer than ``reps``
    records of a name is taken again, up to three times (once in a while
    a trace holds none at all, so a trace without the kernel is taken
    again too); the trace that kept the most counts if it holds at least
    half of them.  A record too many is an error at once, and so is no
    record in any of the three traces (a wrong name).  ``parts`` gets each
    name's mean."""
    from torch.profiler import ProfilerActivity, profile

    names = (name,) if isinstance(name, str) else tuple(name)
    fn()
    torch.cuda.synchronize()
    best = None
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        kern = {n: [e for e in events if n in e.key] for n in names}
        counts = {n: sum(e.count for e in k) for n, k in kern.items()}
        if max(counts.values()) > reps:
            raise AssertionError(f"the profiler saw {counts} launches, not {reps} of each")
        if best is None or min(counts.values()) > min(best[1].values()):
            best = (kern, counts)
        if all(c == reps for c in counts.values()):
            break
        say(f"  profiler kept {counts} of {reps} records (attempt {attempt + 1})")
    kern, counts = best
    count = min(counts.values())
    if 2 * count < reps:
        raise AssertionError(f"the profiler saw {counts} launches, not {reps} of each")
    means = {n: sum(e.device_time_total for e in k) / counts[n] / 1e3 for n, k in kern.items()}
    if parts is not None:
        parts.update(means)
    return sum(means.values()), count


def _device_ms_a_call(fn, reps: int = 20) -> float:
    r"""The device time of one call of ``fn`` (every kernel, copy and
    fill it puts on the card, summed over a ``torch.profiler`` trace of
    ``reps`` calls, over ``reps``): for work dispatched op by op, whose
    wall between two CUDA events would count the host's gaps too."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    busy = sum(
        e.time_range.elapsed_us() for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
    )
    return busy / reps / 1e3


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


def _time_case(kernel, plain, bound, name="tile_search_kernel", parts=False) -> dict:
    r"""Kernel time (profiler), the same call with its host dispatch
    (events), the plain version's time, and the bound with its share;
    with ``parts``, each launch's time by name (``parts_ms``)."""
    out = dict(bound)
    if parts:
        out["parts_ms"] = {}
    out["ms"], out["ms_over"] = _kernel_ms(kernel, name, parts=out.get("parts_ms"))
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
        (8192, 256, 256, "fit", ""), (8192, 512, 256, "fit", ""),
        (8192, 256, 256, "spread", "empty"), (2048, 64, 33, "few", ""),
        (2048, 64, 13, "few", ""), (8192, 256, 256, "few", "ties"),
        (8192, 256, 256, "one", "long"),
    ]
    max_err = 0.0
    timing = {}
    library_ms = {}
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
        if m == 8192 and f8 == 256 and not kind:
            key = conc if fc == 256 else f"{conc} Fc={fc}"
            timing[key] = _time_case(kernel, plain, _bound(row_group, pending, t_pk.shape))
            line += _timing_text(timing[key])
        say(line)
        if m == 8192 and f8 == 256 and conc == "one" and not kind:
            library_ms[fc] = _int_mm_ms(row_pk, t_pk)
    return {"max_abs_err": max_err, "timing": timing, "library_ms": library_ms[256]}


def _int_mm_ms(row_pk, t_pk) -> float:
    r"""torch._int_mm of the unpacked int8 rows (8192 x 2048) against one
    group's unpacked tile (2048 x Fc, Fc = 256 or 512): intersections only
    (no Tanimoto, no argmax, one tile for every row), so not the same
    function; the sorted front end's library yardstick.  Prints and
    returns its ms a call."""
    from bblean_tpu_torch.engine.batch import unpack_fingerprints_device

    f = row_pk.shape[1] * 8
    a = unpack_fingerprints_device(row_pk, f).to(torch.int8).contiguous()
    b = unpack_fingerprints_device(t_pk[0], f).to(torch.int8).contiguous().t()
    ms = _median_ms(lambda: torch._int_mm(a, b))
    say(
        f"phase 2 information: torch._int_mm {tuple(a.shape)} x {tuple(b.shape)} "
        f"int8 -> int32, intersections only: {ms:.4f} ms (events, median of 15)"
    )
    return ms


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
        (2048, 256, 256, "fit", ""), (2048, 512, 256, "fit", ""),
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
        if m == 2048 and f8 == 256 and not kind:
            key = conc if fc == 256 else f"{conc} Fc={fc}"
            timing[key] = _time_case(kernel, plain, _bound(row_group, pending, t_pk.shape))
            line += _timing_text(timing[key])
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


def _route_inputs(gen, m, f, g_cap, ties=()):
    r"""0/1 rows and centroids at 20% density on the card: centroid 3 copied
    to the columns ``ties`` and a third of the rows copies of it (with
    ``ties``), row 5 and centroid 7 all zero, a tenth of the rows not
    pending."""
    dev = gen.device
    rows = (torch.rand((m, f), generator=gen, device=dev) < 0.2).to(torch.int8)
    cent = (torch.rand((g_cap, f), generator=gen, device=dev) < 0.2).to(torch.int8)
    if ties:
        cent[list(ties)] = cent[3].clone()
        rows[1::3] = cent[3]
    rows[5] = 0
    cent[7] = 0
    pending = torch.rand(m, generator=gen, device=dev) >= 0.1
    return (
        rows, rows.sum(1, dtype=torch.int32), cent, cent.sum(1, dtype=torch.int32), pending,
    )


def route_near_tie(f: int) -> tuple[int, int, int, int]:
    r"""(i1, u1, i2, u2): two Tanimoto fractions i1/u1 < i2/u2 with unions
    at most ``f`` whose f32 quotients are equal (IEEE division), the
    closest first: (u - k)/u for k = 1, 2, ... and two unions among the
    top 64.  None exists where unions stay at or below 2048 (the gap
    between two such fractions is above half an f32 step); at ``f`` =
    8192 the first is (8190/8191, 8191/8192)."""
    f32 = np.float32
    for k in range(1, 64):
        for u1 in range(f - 1, max(f - 64, k), -1):
            for u2 in range(u1 + 1, f + 1):
                i1, i2 = u1 - k, u2 - k
                if f32(i1) / f32(u1) == f32(i2) / f32(u2):
                    return i1, u1, i2, u2
    raise ValueError(f"no near tie with unions of at most {f}")


def route_near_tie_inputs(rng, m: int, f: int, g_cap: int, cols: tuple[int, int]):
    r"""numpy inputs of a near tie: 0/1 rows and centroids at 20% density;
    the even rows are one row R of ``max(i1, i2)`` ones, centroid
    ``cols[0]`` meets R in i1 / u1 and centroid ``cols[1]`` in i2 / u2
    (``route_near_tie(f)``: larger exactly, equal in f32); every third row
    is not pending.  The route must give R's pending rows ``cols[0]``, the
    earlier of the two columns of largest f32 sim."""
    i1, u1, i2, u2 = route_near_tie(f)
    pr = max(i1, i2)
    rows = (rng.random((m, f)) < 0.2).astype(np.int8)
    cent = (rng.random((g_cap, f)) < 0.2).astype(np.int8)
    rows[::2] = 0
    rows[::2, :pr] = 1
    for c, i, u in ((cols[0], i1, u1), (cols[1], i2, u2)):
        cent[c] = 0
        cent[c, :i] = 1  # i bits shared with R
        cent[c, pr:u] = 1  # u - pr bits outside R: the union is u
    pending = np.ones(m, bool)
    pending[::3] = False
    return rows, rows.sum(1).astype(np.int32), cent, cent.sum(1).astype(np.int32), pending


def prefix_commit_case(rng, m: int, f: int, layout: str, big: bool = False,
                       vote_edge: bool = False):
    r"""numpy inputs of one round's merge tests: the rows' sums (M, F) and
    counts, each row's candidate's sums and count, the accept mask of the
    screen and the candidate key (accepted rows that share a key form one
    segment of the prefix commits).  Candidates are noisy members of a
    prototype at 25% density (bits at 85% / 4%) with 1-39 members; a row is
    one member with 0-50% noise.  ``layout`` is one of
    ``PREFIX_LAYOUTS``: "singletons" (every key once), "one segment" (one
    key), "mixed" (M / 8 keys), "t=0.3 runs" (keys drawn with weights
    1 / rank^1.5: a few segments of hundreds to thousands of rows), "none
    accepted"; the first two accept every row, the next two 75%.
    ``big``: buffer rows and candidates of up to 2^17 members (sums past
    2^16, Ksq past 2^31).  ``vote_edge``: 30% of the columns sit at the
    majority vote's edge: at even rows the merged count is even and the
    merged sums half of it, at odd rows the candidate's count is even and
    its sums half of it; row 0 sums to 2^24 at a merged count of 2^25 + 1
    (the f32 vote says 1 where 2 x >= n would say 0); row 1's candidate is
    empty (a merged count of 1: the 0/1 path)."""
    k = m if layout == "singletons" else max(1, m // 8)
    if layout == "singletons":
        best = rng.permutation(m)
    elif layout == "one segment":
        best = np.zeros(m, np.int64)
    elif layout == "t=0.3 runs":
        w = 1.0 / np.arange(1, k + 1) ** 1.5
        best = rng.choice(k, m, p=w / w.sum())
    else:
        best = rng.integers(0, k, m)
    if layout in ("mixed", "t=0.3 runs"):
        accept = rng.random(m) < 0.75
    else:
        accept = np.full(m, layout != "none accepted")
    hi = 1 << 17 if big else 40
    q = np.where(rng.random((k, f)) < 0.25, 0.85, 0.04)
    clus_n = rng.integers(1, hi, k)
    clus_ls = rng.binomial(clus_n[:, None], q)
    row_n = rng.integers(1, hi, m) if big else np.ones(m, np.int64)
    noise = rng.random(m)[:, None] * 0.5
    row_ls = rng.binomial(row_n[:, None], q[best] * (1 - noise) + 0.25 * noise)
    cand_ls, cand_n = clus_ls[best], clus_n[best]
    if vote_edge:
        cols = rng.random((m, f)) < 0.3
        even = (np.arange(m) % 2 == 0)[:, None]
        cand_n = np.where(even[:, 0], cand_n | 1, np.maximum(cand_n & ~1, 2))
        half = np.where(even, (cand_n[:, None] + row_n[:, None]) // 2 - row_ls, cand_n[:, None] // 2)
        cand_ls = np.where(cols, half, np.minimum(cand_ls, cand_n[:, None]))
        cand_n[0] = 1 << 25
        cand_ls[0] = np.where(cols[0], (1 << 24) - row_ls[0], cand_ls[0])
        cand_n[1] = 0
        cand_ls[1] = 0
    i32 = np.int32
    return (
        row_ls.astype(i32), row_n.astype(i32), cand_ls.astype(i32), cand_n.astype(i32),
        accept, best.astype(i32),
    )


def _route_bound(m: int, f: int, g_num: int) -> dict:
    r"""The least time for one route (or twin) call: the rows, the live
    centroids, both popcount vectors and the pending flags read once and
    the (M,) result written once over 3.35 TB/s; or the product's
    2 * M * G * F int8 operations over 1,979 TOP/s (H100 SXM data sheet)."""
    n_bytes = m * f + g_num * f + 4 * m + 4 * g_num + m + 4 * m
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = 2 * m * g_num * f / INT8_OPS_PER_S
    return {
        "work": f"M={m} x {g_num} live groups x F={f}",
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
    }


def _int_mm_live(rows, cent, g_num: int, block: int):
    r"""``torch._int_mm`` of the rows against the centroids of every live
    block (the product alone: no Tanimoto, no argmax; one call), the
    library yardstick of the route."""
    cols = min(-(-g_num // block) * block, cent.shape[0])
    b = cent[:cols].t()
    return lambda: torch._int_mm(rows, b)


def phase_route() -> dict:
    r"""Phase 2d: the route kernels (``ops/route.py``, ``csrc/route.cu``),
    both epilogues (route: first argmax; twin: max) bit-equal to their plain
    versions: M = 8192, F = 2048 against 65,536 groups at 1; 1,000;
    17,364; 43,008 and 65,536 live, at the 1M fit's and the 10M fits'
    average routes; tied centroids in other blocks and ranges; a block that
    does not divide the table (the clamped last block); 264-bit rows (the
    generic path, counted); the merge's own shape (Q = the receivers' group
    capacity); near ties at F = 8192 in one tile and across ranges.  Each
    F = 2048 case at the engine's block is timed: kernel ms (the product
    and its ranges' combination, profiler), ms a call with dispatch
    (events), the plain version's ms, ``torch._int_mm`` over the same live
    blocks (the library yardstick), the bound and the share."""
    from bblean_tpu_torch.ops import route

    gen = torch.Generator(device="cuda").manual_seed(17)
    base = _route_inputs(gen, ROUTE_M, N_FEATURES, ROUTE_G_CAP)
    ties = [3 + k * 8192 for k in range(1, 6)] + [1500]
    cases = [(f"live {g}", base, g, ROUTE_BLOCK) for g in ROUTE_LIVE]
    cases += [
        ("fit", base, ROUTE_FIT, ROUTE_BLOCK),
        ("10M average", base, ROUTE_10M_AVG, ROUTE_BLOCK),
        ("ties", _route_inputs(gen, ROUTE_M, N_FEATURES, ROUTE_G_CAP, ties), 43_008, ROUTE_BLOCK),
        ("clamped block 1000", base, ROUTE_G_CAP, 1000),
        ("F=264", _route_inputs(gen, ROUTE_M, 264, 4096), 3000, ROUTE_BLOCK),
        ("merge", _route_inputs(gen, MERGE_Q, N_FEATURES, MERGE_Q), MERGE_FIT, ROUTE_BLOCK),
    ]
    rng = np.random.default_rng(23)
    near_cols = {}
    for cols in NEAR_TIE_COLS:
        near = route_near_tie_inputs(rng, ROUTE_M, NEAR_TIE_F, NEAR_TIE_G_CAP, cols)
        near = tuple(torch.from_numpy(a).to("cuda") for a in near)
        near_cols[f"near tie at columns {cols}"] = cols
        cases.append((f"near tie at columns {cols}", near, NEAR_TIE_G_CAP, ROUTE_BLOCK))
    out = {"route": {"timing": {}}, "twin": {"timing": {}}}
    for what, (rows, pops, cent, cpops, pending), g_num, block in cases:
        m, f = rows.shape
        where = f"{what}: M={m} F={f} G_cap={cent.shape[0]} live {g_num} block {block}"
        calls = {
            "route": (
                lambda: route.route_groups(rows, pops, cent, cpops, g_num, pending, block),
                lambda: route.route_groups_plain(rows, pops, cent, cpops, g_num, pending, block),
            ),
            "twin": (
                lambda: route.best_group_sim(rows, pops, cent, cpops, g_num, block),
                lambda: route.best_group_sim_plain(rows, pops, cent, cpops, g_num, block),
            ),
        }
        before = _route_counts()
        got = {k: kernel() for k, (kernel, _plain) in calls.items()}
        ref = {k: plain() for k, (_kernel, plain) in calls.items()}
        torch.cuda.synchronize()
        after = _route_counts()
        tma = f % 16 == 0
        want = (before[0] + 1, before[1] + 1, before[2] + 2 * (not tma), before[3] + 2 * tma)
        if after != want:
            raise AssertionError(f"phase 2d {where}: launches {before} -> {after}, not {want}")
        if not torch.equal(got["route"], ref["route"]):
            raise AssertionError(f"phase 2d {where}: routed groups differ from the plain version's")
        if not torch.equal(got["twin"].view(torch.int32), ref["twin"].view(torch.int32)):
            raise AssertionError(f"phase 2d {where}: best sims differ from the plain version's")
        if what == "ties":
            tied = pending.clone()
            tied[0::3] = False
            tied[2::3] = False
            if not (bool((got["route"][tied] == 3).all()) and bool((got["twin"][1::3] == 1.0).all())):
                raise AssertionError("phase 2d ties: a tie did not keep the first column")
        if what in near_cols:
            cols = near_cols[what]
            i1, u1, _i2, _u2 = route_near_tie(f)
            tied = pending.clone()
            tied[1::2] = False
            sim = torch.tensor(i1, dtype=torch.float32) / torch.tensor(u1, dtype=torch.float32)
            if not (bool((got["route"][tied] == cols[0]).all())
                    and bool((got["twin"][0::2] == sim.item()).all())):
                raise AssertionError(f"phase 2d {where}: the near tie did not keep column {cols[0]}")
        line = f"phase 2d route and twin == plain: {where}"
        if f == N_FEATURES and block == ROUTE_BLOCK and what != "ties":
            bound = _route_bound(m, f, g_num)
            library = _int_mm_live(rows, cent, g_num, block)
            for k, (kernel, plain) in calls.items():
                t = _time_case(kernel, plain, bound, name=ROUTE_KERNELS)
                t["library_ms"] = _median_ms(library)
                out[k]["timing"][what] = t
                line += (
                    f"\n  {k}" + _timing_text(t) + f"; torch._int_mm over the live blocks "
                    f"{t['library_ms']:.4f} ms (events, median of 15)"
                )
        say(line)
    for k in out:
        out[k]["max_abs_err"] = 0.0  # bit-equal, else the phase failed
    out["twin"]["timing"]["fit"] = out["twin"]["timing"]["merge"]
    return out


def prefix_commit_accept(args: tuple, nom_n: torch.Tensor, moments: torch.Tensor) -> torch.Tensor:
    r"""The accept mask of one call of ``prefix_commit_moments`` (its
    arguments ``args``) from its moments: the engine's tail, at phase 2e's
    threshold for the criterion, masked by the call's rows."""
    from bblean_tpu_torch.ops.merges import merge_accept_from_moments

    criterion, new_n, old_n, mask, need = args[0], args[3], args[4], args[6], args[8]
    threshold = PREFIX_THRESHOLD.get(criterion, PREFIX_DEFAULT_THRESHOLD)
    acc = merge_accept_from_moments(
        criterion, threshold, moments, new_n, old_n, nom_n, tolerance=PREFIX_TOLERANCE,
    )
    for keep in (mask, need):
        acc = acc if keep is None else acc & keep
    return acc


def prefix_screened(accept: torch.Tensor) -> torch.Tensor:
    r"""The rows whose screen result a round keeps (the engine's ``pending
    & has_cand & (strikes < 2)``) for ``prefix_commit_case``'s screen: the
    rows it accepts and two of every three others."""
    idx = torch.arange(accept.shape[0], device=accept.device)
    return accept | (idx % 3 != 0)


def prefix_commit_uses(criterion: str, case: tuple, device, need: bool = False) -> dict:
    r"""The insert round's three calls of ``prefix_commit_moments`` on
    ``case`` (``prefix_commit_case``'s arrays, moved to ``device``), made
    as the engine makes them: "screen" (every row its own segment), "pass
    1" (the accepted rows sorted by key, in segments) and "pass 2" (the
    rows that pass 1 accepts, by the plain version and the tail).  With
    ``need``, each call passes the rows whose result the round keeps, as
    the engine does (the screen: ``prefix_screened``; a pass: its mask);
    without, none (every row).  Each is (the call's arguments, its nominee
    counts)."""
    from bblean_tpu_torch.engine import batch as engine
    from bblean_tpu_torch.ops import prefix_commit as pc

    row_ls, row_n, cand_ls, cand_n, accept, best = (torch.from_numpy(a).to(device) for a in case)
    m = row_ls.shape[0]
    screened = prefix_screened(accept) if need else None
    uses = {
        "screen": (
            (criterion, row_ls, cand_ls, cand_n + row_n, cand_n, None, None, None, screened),
            row_n,
        ),
    }
    order, _grp, start = engine._group_ids_by_key(torch.where(accept, best, engine._BIG))
    idx = torch.arange(m, dtype=torch.int32, device=row_ls.device)
    seg = torch.cummax(torch.where(start, idx, 0), dim=0).values.long()
    inc = accept[order]
    for name in ("pass 1", "pass 2"):
        new_n, old_n, s_n = engine._prefix_counts(inc, row_n[order], cand_n[order], seg)
        args = (criterion, row_ls, cand_ls, new_n, old_n, order, inc, seg, inc if need else None)
        uses[name] = (args, s_n)
        inc = prefix_commit_accept(args, s_n, pc.prefix_commit_moments_plain(*args))
    return uses


def prefix_lookback_case(rng, m: int, f: int, rows: int, kind: str) -> tuple:
    r"""numpy arguments of one call of ``prefix_commit_moments``
    (tolerance-radius: all eight moments) that stresses the look-back
    across chunks of ``rows`` sorted rows (``ops/prefix_commit.py::
    _chunk_rows``).  ``kind`` is one of ``PREFIX_STRESS``: "one segment"
    (every row in one segment, in the mask and needed); "chunk-aligned
    segments" (segments start exactly at chunk boundaries: at each of the
    first third of the chunks and at every fifth after; 75% of the rows in
    the mask, needed = mask); "long stretches without need" (one segment,
    every row in the mask, needed only in chunks 0-3, 100 and the last
    two); "zero stretches" (one segment; chunks 4 to the last three hold no
    row in the mask or need, so the last chunks look back through zero
    tails); "screen stretches" (no segments, no order, needed rows only in
    chunks 0-3 and the last three).  Sums and counts as
    ``prefix_commit_case``'s "mixed" layout, the order a permutation."""
    row_ls, row_n, cand_ls, cand_n, _accept, _best = prefix_commit_case(rng, m, f, "mixed")
    idx = np.arange(m)
    chunk = idx // rows
    last = chunk[-1]
    order = rng.permutation(m).astype(np.int64)
    mask = np.ones(m, bool)
    seg = np.zeros(m, np.int64)
    if kind == "one segment":
        need = mask
    elif kind == "chunk-aligned segments":
        starts = (idx % rows == 0) & ((chunk < (last + 1) // 3) | (chunk % 5 == 0))
        seg = np.maximum.accumulate(np.where(starts, idx, 0)).astype(np.int64)
        mask = rng.random(m) < 0.75
        need = mask
    elif kind == "long stretches without need":
        need = (chunk < 4) | (chunk == 100) | (chunk >= last - 1)
    elif kind == "zero stretches":
        mask = (chunk < 4) | (chunk >= last - 2)
        need = mask
    else:
        order = mask = seg = None
        need = (chunk < 4) | (chunk >= last - 2)
    return (
        "tolerance-radius", row_ls, cand_ls, (row_n + cand_n).astype(np.int32), cand_n,
        order, mask, seg, need,
    )


def _prefix_bound(m: int, f: int, n_mom: int, segments: bool, read: int,
                  needed: int | None = None) -> dict:
    r"""The least time for one call: the ``read`` rows of ``row_ls`` that
    the result depends on read once, ``cand_ls`` read once for the
    ``needed`` rows (every row where the call passes no ``need``), the
    counts, the order, the mask, the segment starts and ``need`` read once
    and the (moments, M) int64 result written once, over 3.35 TB/s.  The
    arithmetic (a few integer operations a column) is far below the
    bytes."""
    n_bytes = (
        ((m if needed is None else needed) + read) * f * 4 + 2 * m * 4
        + (m * (8 + 1 + 8) if segments else 0) + (0 if needed is None else m) + 8 * n_mom * m
    )
    work = f"M={m} ({read} of row_ls read"
    work += ")" if needed is None else f", {needed} needed)"
    return {
        "work": f"{work} x F={f}, {n_mom} moments",
        "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
    }


def _prefix_reads(args: tuple) -> tuple[int, int, int]:
    r"""One call's row counts for the bounds: the rows of ``row_ls`` its
    mask lets in (every row without a mask), the rows of ``row_ls`` the
    result depends on (with segments those; without, those in ``need``
    too) and the needed rows (every row without ``need``)."""
    row_ls, mask, seg_start, need = args[1], args[6], args[7], args[8]
    m = row_ls.shape[0]
    in_mask = m if mask is None else int(mask.sum())
    needed = m if need is None else int(need.sum())
    if seg_start is not None or need is None:
        read = in_mask
    else:
        read = needed if mask is None else int((mask & need).sum())
    return in_mask, read, needed


def phase_prefix_commit() -> dict:
    r"""Phase 2e: the prefix-commit kernel (``ops/prefix_commit.py``,
    ``csrc/prefix_commit.cu``) bit-equal to its plain version, moments and
    accept masks, for the round's three calls (screen, pass 1, pass 2) and
    all six criteria, each without ``need`` and with it as the engine
    passes it: at M = 8192 and 2048 rows of 2048 bits in every layout of
    ``PREFIX_LAYOUTS`` (long t = 0.3-like segments among them), with
    buffer rows of sums past 2^16, and at the majority vote's edge; and at
    100 bits (plain loads), 2050 and 4100 bits (several column tiles
    adding into the moments).  Then the look-back's stress cases
    (``prefix_lookback_case``) at 8,187 rows, each bit-equal on each of
    ``PREFIX_STRESS_LAUNCHES`` launches and ``PREFIX_STRESS_REPLAYS``
    replays of a CUDA graph.  Timed on the t = 0.3-like layout with the
    fit's criterion (diameter) at both widths, with and without ``need``:
    kernel ms (profiler), ms a call with dispatch (events), the plain
    version's ms, both bounds (``_time_prefix``) and ``torch.cumsum(dim=0,
    dtype=int32)`` of one (M, F) int32 plane (the library yardstick: the
    call each pass replaces twice), each over copies of its inputs taken
    in turn, so that the tables come from HBM at M = 2048 too.  One pass
    at M = 8192 must take less time a call than that scan.  The kernels
    line's record is timed on a round of the fit (phase 4), not on these
    made-up layouts."""
    from bblean_tpu_torch.ops import prefix_commit as pc
    from bblean_tpu_torch.ops.merges import DEVICE_MERGES, moment_count

    rng = np.random.default_rng(29)
    cases = [(shape, layout, {}) for shape in PREFIX_SHAPES for layout in PREFIX_LAYOUTS]
    cases += [(shape, "mixed", {"big": True}) for shape in PREFIX_SHAPES]
    cases += [(shape, "singletons", {"vote_edge": True}) for shape in PREFIX_SHAPES]
    cases += [((1000, 100), "t=0.3 runs", {}), ((300, 2050), "mixed", {}), ((600, 4100), "one segment", {})]
    timing = {}
    for (m, f), layout, kw in cases:
        case = prefix_commit_case(rng, m, f, layout, **kw)
        _keys, sizes = np.unique(case[5][case[4]], return_counts=True)
        what = (
            f"M={m} F={f} {layout}{''.join(' ' + k for k in kw)} ({len(sizes)} segments, "
            f"longest {sizes.max() if len(sizes) else 0})"
        )
        for criterion in DEVICE_MERGES:
            for need in (False, True):
                for mode, (args, nom_n) in prefix_commit_uses(criterion, case, "cuda", need).items():
                    before = pc.launches
                    got = pc.prefix_commit_moments(*args)
                    ref = pc.prefix_commit_moments_plain(*args)
                    torch.cuda.synchronize()
                    where = f"phase 2e {what} {criterion} {mode}{' with need' if need else ''}"
                    if pc.launches != before + (moment_count(criterion) > 0):
                        raise AssertionError(f"{where}: launches {before} -> {pc.launches}")
                    if not torch.equal(got, ref):
                        raise AssertionError(f"{where}: moments differ from the plain version's")
                    if not torch.equal(
                        prefix_commit_accept(args, nom_n, got), prefix_commit_accept(args, nom_n, ref)
                    ):
                        raise AssertionError(f"{where}: accept masks differ from the plain version's")
        line = (
            f"phase 2e prefix commits == plain: {what}, 6 criteria x screen, pass 1, pass 2, "
            f"without and with need"
        )
        if layout == "t=0.3 runs" and not kw and (m, f) in PREFIX_SHAPES:
            for need in (True, False):
                for mode, (args, _nom_n) in prefix_commit_uses("diameter", case, "cuda", need).items():
                    key = f"M={m} {mode}" + ("" if need else " without need")
                    t = timing[key] = _time_prefix(args)
                    line += f"\n  {mode}{'' if need else ' without need'}" + _prefix_timing_text(t)
        say(line)
    for kind in PREFIX_STRESS:
        say(f"phase 2e look-back stress == plain: {_prefix_stress(rng, kind)}")
    # A pass over the wide rounds' 8,192 rows
    wide = timing[f"M={PREFIX_SHAPES[0][0]} pass 1"]
    if wide["call_ms"] >= wide["library_ms"]:
        raise AssertionError(
            f"phase 2e: one pass takes {wide['call_ms']:.4f} ms a call, the scan it replaces "
            f"{wide['library_ms']:.4f} ms"
        )
    return {"max_abs_err": 0.0, "timing": timing}  # bit-equal, else the phase failed


def prefix_stress_args(rng, kind: str, device) -> tuple:
    r"""``prefix_lookback_case`` at ``PREFIX_STRESS_M`` x 2048 bits with
    the chunk the wrapper picks on ``device``'s card, on ``device``."""
    from bblean_tpu_torch.ops import prefix_commit as pc

    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    rows = pc._chunk_rows(PREFIX_STRESS_M, N_FEATURES, n_sm)
    case = prefix_lookback_case(rng, PREFIX_STRESS_M, N_FEATURES, rows, kind)
    return tuple(torch.from_numpy(a).to(device) if isinstance(a, np.ndarray) else a for a in case)


def prefix_stress_check(args: tuple) -> None:
    r"""The kernel bit-equal to the plain version on each of
    ``PREFIX_STRESS_LAUNCHES`` launches of one call and each of
    ``PREFIX_STRESS_REPLAYS`` replays of it captured in a CUDA graph (the
    ticket and the look-back's words zeroed by a node of the graph)."""
    from bblean_tpu_torch.ops import prefix_commit as pc

    ref = pc.prefix_commit_moments_plain(*args)
    for k in range(PREFIX_STRESS_LAUNCHES):
        if not torch.equal(pc.prefix_commit_moments(*args), ref):
            raise AssertionError(f"launch {k}: moments differ from the plain version's")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        pc.prefix_commit_moments(*args)  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = pc.prefix_commit_moments(*args)
    for k in range(PREFIX_STRESS_REPLAYS):
        out.fill_(-1)
        graph.replay()
        if not torch.equal(out, ref):
            raise AssertionError(f"graph replay {k}: moments differ from the plain version's")


def _prefix_stress(rng, kind: str) -> str:
    args = prefix_stress_args(rng, kind, "cuda")
    try:
        prefix_stress_check(args)
    except AssertionError as e:
        raise AssertionError(f"phase 2e look-back stress {kind}: {e}") from None
    m, f = args[1].shape
    in_mask, _read, needed = _prefix_reads(args)
    segs = "no segments"
    if args[7] is not None:
        segs = f"{int((args[7] == torch.arange(m, device=args[7].device)).sum())} segments"
    return (
        f"{kind}: M={m} F={f}, {in_mask} rows in the mask, {needed} needed, {segs}; "
        f"{PREFIX_STRESS_LAUNCHES} launches and {PREFIX_STRESS_REPLAYS} graph replays"
    )


def _copies(args: tuple, big: int) -> list[tuple]:
    r"""Copies of one call's arguments on the card, enough that ``big``
    bytes of its inputs a copy take four times the L2 together (at least
    two; the prefix commits' tables ``row_ls`` and ``cand_ls``: 2 copies at
    M = 8192, 7 at M = 2048): a timed call that takes the next copy each
    time reads its inputs from HBM, as the bound assumes."""
    n = max(2, -(-4 * L2_BYTES // max(big, 1)))

    def copy(a):
        if isinstance(a, torch.Tensor):
            return a.to("cuda", copy=True)
        if isinstance(a, tuple):
            return tuple(copy(x) for x in a)
        return a

    return [copy(args) for _ in range(n)]


def _in_turn(copies: list):
    r"""A function that returns the next of ``copies`` at each call."""
    turn = [0]

    def take():
        turn[0] += 1
        return copies[turn[0] % len(copies)]

    return take


def _time_prefix(args: tuple) -> dict:
    r"""One call of the prefix commits timed (``_time_case``) over copies
    of its arguments taken in turn (``_copies`` of its tables), beside the bound for
    this call's rows (``_prefix_bound``: ``cand_ls`` for the needed rows,
    ``row_ls`` for the rows the result depends on) and the bound that
    charges ``cand_ls`` whole and ``row_ls`` for the rows in the mask
    (``bound_full_ms``, ``share_full``), and ``torch.cumsum(dim=0,
    dtype=int32)`` of one of its (M, F) int32 planes (the library
    yardstick: the call each pass replaces twice), also in turn."""
    from bblean_tpu_torch.ops import prefix_commit as pc
    from bblean_tpu_torch.ops.merges import moment_count

    copies = _copies(args, 2 * args[1].numel() * 4)
    take = _in_turn(copies)

    criterion, row_ls, seg_start, need = args[0], args[1], args[7], args[8]
    m, f = row_ls.shape
    n_mom = moment_count(criterion)
    in_mask, read, needed = _prefix_reads(args)
    t = _time_case(
        lambda: pc.prefix_commit_moments(*take()),
        lambda: pc.prefix_commit_moments_plain(*take()),
        _prefix_bound(m, f, n_mom, seg_start is not None, read, None if need is None else needed),
        name=PREFIX_KERNELS,
    )
    t["bound_full_ms"] = _prefix_bound(m, f, n_mom, seg_start is not None, in_mask)["bound_ms"]
    t["share_full"] = t["bound_full_ms"] / t["ms"]
    t["library_ms"] = _median_ms(lambda: torch.cumsum(take()[1], 0, dtype=torch.int32))
    t["copies"] = len(copies)
    return t


def _prefix_timing_text(t: dict) -> str:
    m = t["work"].split()[0]
    return _timing_text(t) + (
        f"; the bound with cand_ls read whole {t['bound_full_ms']:.4g} ms, share "
        f"{t['share_full']:.3f}; torch.cumsum(dim=0) of one {m} int32 plane "
        f"{t['library_ms']:.4f} ms (events, median of 15); each timed over {t['copies']} "
        f"copies of its inputs in turn"
    )


# Phase 2f: the leader election's layouts (``election_case``), its
# threshold (the fit's t = 0.3), the kernel's three launches as the
# profiler names them (the rejected rows listed by group, the leaders, the
# best leaders), the ways a round calls it (the ``plan`` of
# ``election_args``: a wide round's rows are the step's, a narrow round's a
# selection of them) and the graph replays of a case
ELECTION_LAYOUTS = ("one group", "t=0.3 groups", "fit round", "ties", "force lead", "none rejected")
ELECTION_THRESHOLD = 0.3
ELECTION_KERNELS = ("election_compact_kernel", "election_leads_kernel", "election_best_kernel")
ELECTION_MODES = {"wide round": "wide", "narrow round": "narrow"}
# Phase 2g: the pool and tile writes' layouts (``commit_writes_case``) and
# the kernel's two launches; both phases replay one case this many times
WRITES_LAYOUTS = ("t=0.3 runs", "one segment", "singletons", "edges", "mixed")
WRITES_KERNELS = ("writes_sets_kernel", "writes_adds_cells_kernel")
REPLAYS = 20


def election_case(rng, m: int, f: int, layout: str) -> tuple:
    r"""numpy inputs of one round's leader election: (rejected, force_lead,
    row_group, valid, row_pk, row_pop).  ``layout`` is one of
    ``ELECTION_LAYOUTS``: "one group" (every row on group 0 and rejected:
    a fit's first batch), "t=0.3 groups" (M / 5 groups drawn with weights
    1 / rank^1.5: about 1,600 at M = 8192, a few of hundreds of rows, most
    of one or two, as a mid-fit round), "ties" (every row a copy of one of
    three prototypes of its group: duplicate rows and equal sims), "force
    lead" (40% of the rejected rows struck twice), "none rejected".  Rows
    are noisy copies of their group's prototype (25% of bits set, 0-30% of
    them flipped), so that sims fall on both sides of the threshold; 3% of
    the rows are padding (not valid, routed to group 0 as the route leaves
    them), 60% of the valid rows rejected, 5% of those struck twice.
    "fit round" is cut to the 1M t = 0.3 fit's mid-fit wide round: groups
    as "t=0.3 groups" with half the rows moved to group 0 (about 69% of
    the rows there: one group of a few thousand rows), 15% of group 0's
    rows and 5% of the others' rejected (about 12% in all, most in group
    0)."""
    if layout == "one group":
        k, group = 1, np.zeros(m, np.int64)
    elif layout in ("t=0.3 groups", "fit round"):
        k = max(1, m // 5)
        w = 1.0 / np.arange(1, k + 1) ** 1.5
        group = rng.choice(k, m, p=w / w.sum())
        if layout == "fit round":
            group = np.where(rng.random(m) < 0.5, 0, group)
    else:
        k = max(1, m // 16)
        group = rng.integers(0, k, m)
    if layout == "ties":
        protos = rng.random((k, 3, f)) < 0.25
        bits = protos[group, rng.integers(0, 3, m)]
    else:
        protos = rng.random((k, f)) < 0.25
        flip = rng.random((m, f)) < rng.random(m)[:, None] * 0.3
        bits = protos[group] ^ (flip & (rng.random((m, f)) < 0.5))
    valid = np.ones(m, bool) if layout == "one group" else rng.random(m) < 0.97
    group = np.where(valid, group, 0)
    if layout == "one group":
        rejected = valid.copy()
    elif layout == "none rejected":
        rejected = np.zeros(m, bool)
    elif layout == "fit round":
        rejected = valid & (rng.random(m) < np.where(group == 0, 0.15, 0.05))
    else:
        rejected = valid & (rng.random(m) < 0.6)
    force = rejected & (rng.random(m) < (0.4 if layout == "force lead" else 0.05))
    return (
        rejected, force, group.astype(np.int32), valid, np.packbits(bits, axis=1),
        bits.sum(1).astype(np.int32),
    )


def election_args(case: tuple, device, plan: str | None, sims: bool = False) -> tuple:
    r"""The arguments of ``elect_leaders`` on ``device`` for ``case``
    (``election_case``'s arrays): the packed rows and popcounts (as the
    rounds pass them) or, with ``sims``, an all-pairs row Gram
    (``tanimoto_gram`` of the rows: JAX's wide rounds' input, which only
    the plain version takes).  ``plan``: "wide", the step's sort plan (the
    valid rows by group, padding rows on a guard key), as a wide round
    passes it; "narrow", the case's rows a selection ``sel`` of a step of
    4M rows (the valid rows on rising step rows, the padding rows on
    falling ones, the other step rows on random groups) and that step's
    plan, ``(order, skey, sel)``, as a narrow round passes it; None, no
    plan (the plain version needs none)."""
    from bblean_tpu_torch.ops.leader_election import tanimoto_gram
    from bblean_tpu_torch.ops.packing import unpack_fingerprints_device

    rejected, force, group, valid, row_pk, row_pop = (torch.from_numpy(a).to(device) for a in case)
    threshold = torch.tensor(ELECTION_THRESHOLD, dtype=torch.float32, device=device)
    gram = pk = pop = None
    if sims:
        gram = tanimoto_gram(unpack_fingerprints_device(row_pk).to(torch.int8), row_pop)
    else:
        pk, pop = row_pk, row_pop
    guard = 1 << 30
    if plan == "wide":
        skey, order = torch.sort(torch.where(valid, group, guard), stable=True)
        plan = (order, skey)
    elif plan == "narrow":
        m, ok = len(case[0]), case[3]
        rng = np.random.default_rng(m)
        at = np.sort(rng.choice(4 * m, m, replace=False))
        sel = np.empty(m, np.int64)
        sel[ok] = at[: ok.sum()]
        sel[~ok] = at[ok.sum():][::-1]
        key = rng.integers(0, int(case[2].max()) + 2, 4 * m).astype(np.int32)
        key[sel] = np.where(ok, case[2], guard)
        skey, order = torch.sort(torch.from_numpy(key), stable=True)
        plan = (order.to(device), skey.to(device), torch.from_numpy(sel).to(device))
    return rejected, force, group, threshold, gram, pk, pop, plan


def _pairs(rows_j: np.ndarray, group: np.ndarray, rows_i: np.ndarray) -> int:
    r"""The pairs (j, i) with i < j on one group, j in ``rows_j`` and i in
    ``rows_i``."""
    order = np.argsort(group, kind="stable")
    g, rj, ri = group[order], rows_j[order], rows_i[order].astype(np.int64)
    starts = np.r_[True, g[1:] != g[:-1]]
    excl = np.cumsum(ri) - ri
    return int(((excl - np.maximum.accumulate(np.where(starts, excl, 0))) * rj).sum())


def election_pairs(rejected: np.ndarray, group: np.ndarray) -> int:
    r"""The pairs (j, i) the full election's result depends on (the
    earlier contract: every row's best leader): i < j, i rejected, both on one
    group."""
    return _pairs(np.ones(len(rejected), bool), group, rejected)


def election_contract_pairs(rejected: np.ndarray, group: np.ndarray, leads: np.ndarray) -> tuple[int, int]:
    r"""The pairs the kernel's contract needs: the leads pairs (a rejected
    j against the lower rejected rows of its group) and the best-leader
    pairs (a rejected j that does not lead against the lower leaders of
    its group, a subset of the former)."""
    return _pairs(rejected, group, rejected), _pairs(rejected & ~leads, group, leads)


def _election_bound(args: tuple, leads: torch.Tensor) -> dict:
    r"""The least time for one election under the kernel's contract: the
    rejected rows' packed bits and popcounts read once and each leads pair
    (``election_contract_pairs``; the best-leader pairs are among them)
    an AND + popcount of F bits, counted as F int8 multiply-adds (2
    operations each, a stand-in: no binary-mma peak is published) over
    1,979 TOP/s; the flags and the sort plan (its ``sel`` too) read and
    the three (M,) outputs written once, over 3.35 TB/s; the larger of the
    two.  ``bound_full_ms`` is the earlier, full contract's bound, the
    same way: every row's pairs (``election_pairs``), every row's groups
    read."""
    rejected, group, pk, plan = args[0], args[2], args[5], args[7]
    m, f = rejected.shape[0], pk.shape[1] * 8
    rej, grp = rejected.cpu().numpy(), group.cpu().numpy()
    n_rej = int(rej.sum())
    lead_pairs, best_pairs = election_contract_pairs(rej, grp, leads.cpu().numpy())
    full = election_pairs(rej, grp)
    plan_bytes = plan[0].shape[0] * (8 + 4) + (m * 8 if len(plan) == 3 else 0)
    rows = m * (1 + 1 + 4) + m * (1 + 4 + 4) + n_rej * (pk.shape[1] + 4)

    def bound(n_bytes: int, pairs: int) -> tuple[float, str]:
        t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, 2 * f * pairs / INT8_OPS_PER_S
        return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"

    bound_ms, bound_by = bound(rows + plan_bytes, lead_pairs)
    return {
        "work": (
            f"M={m} ({n_rej} rejected, {lead_pairs} leads pairs, {best_pairs} best-leader "
            f"pairs, {full} pairs of every row, {'wide' if len(plan) == 2 else 'narrow'} round's plan)"
        ),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "pairs": lead_pairs, "best_pairs": best_pairs, "full_pairs": full,
        "bound_full_ms": bound(rows + plan_bytes + 4 * m, full)[0],
    }


def _election_equal(got: tuple, ref: tuple, rejected: torch.Tensor) -> bool:
    r"""The kernel's contract against the plain version's outputs: leads
    equal on every row; lead_of and best_lead_sim bit-equal on the rows
    with ``rejected & ~leads``, and 0 and ``_NEG`` on every other row."""
    c = rejected & ~ref[0]
    return (
        torch.equal(got[0], ref[0]) and torch.equal(got[1][c], ref[1][c])
        and torch.equal(got[2][c].view(torch.int32), ref[2][c].view(torch.int32))
        and bool((got[1][~c] == 0).all()) and bool((got[2][~c] == -2.0).all())
    )


def _time_election(args: tuple) -> dict:
    r"""One election timed (``_time_case``, each launch's share too) over
    copies of its arguments in turn, beside the bound of its contract and
    the full one (``_election_bound``); no PyTorch call computes this
    function (library: none)."""
    from bblean_tpu_torch.ops import leader_election as le

    copies = _copies(args, args[5].numel())
    take = _in_turn(copies)
    t = _time_case(
        lambda: le.elect_leaders(*take()), lambda: le.elect_leaders_plain(*take()),
        _election_bound(args, le.elect_leaders_plain(*args)[0]), name=ELECTION_KERNELS,
        parts=True,
    )
    t["share_full"] = t["bound_full_ms"] / t["ms"]
    t["library_ms"] = None
    t["copies"] = len(copies)
    return t


def _election_timing_text(t: dict) -> str:
    return _timing_text(t) + (
        f"; the full contract's bound {t['bound_full_ms']:.4g} ms, share {t['share_full']:.3f}; "
        f"launches " + ", ".join(f"{k} {v:.4f}" for k, v in t["parts_ms"].items())
        + f" ms; over {t['copies']} copies"
    )


def _election_check(args: tuple, where: str) -> None:
    r"""The kernel's outputs against the plain version's (``_election_equal``),
    one launch."""
    from bblean_tpu_torch.ops import leader_election as le

    before = le.launches
    got = le.elect_leaders(*args)
    ref = le.elect_leaders_plain(*args)
    torch.cuda.synchronize()
    if le.launches != before + 1:
        raise AssertionError(f"{where}: launches {before} -> {le.launches}")
    if not _election_equal(got, ref, args[0]):
        raise AssertionError(f"{where}: leads, lead_of or best_lead_sim differ from the plain version's")


def _election_replays(args: tuple) -> None:
    r"""One election captured in a CUDA graph, replayed ``REPLAYS`` times
    over outputs spoiled before each (the scratch the capture took is
    reused by every replay): each equal to the plain version."""
    from bblean_tpu_torch.ops import leader_election as le

    ref = le.elect_leaders_plain(*args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        le.elect_leaders(*args)  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = le.elect_leaders(*args)
    for k in range(REPLAYS):
        out[0].fill_(True)
        out[1].fill_(-7)
        out[2].fill_(9.0)
        graph.replay()
        torch.cuda.synchronize()
        if not _election_equal(out, ref, args[0]):
            raise AssertionError(f"phase 2f graph replay {k}: the election differs from the plain version's")


def phase_election() -> dict:
    r"""Phase 2f: the leader-election kernel (``ops/leader_election.py``,
    ``csrc/leader_election.cu``) against its plain version (leads on every
    row, lead_of and best_lead_sim on the rows the round reads:
    ``_election_equal``) in every layout of ``ELECTION_LAYOUTS`` at the
    wide rounds' 8,192 rows and the narrow rounds' 2,048, 2048 bits, in
    both modes of ``ELECTION_MODES``; then ``REPLAYS`` replays of a
    captured call in each.  Timed on the "t=0.3 groups" and "fit round"
    layouts, at 8,192 rows as a wide round and at 2,048 as a narrow round,
    over copies of the inputs in turn (4x the L2).  The kernels line's
    record is timed on a round of the fit (phase 4)."""
    rng = np.random.default_rng(31)
    timed = {8192: "wide round", 2048: "narrow round"}
    timing = {}
    replay = []
    for m in (8192, 2048):
        for layout in ELECTION_LAYOUTS:
            case = election_case(rng, m, N_FEATURES, layout)
            for mode, plan in ELECTION_MODES.items():
                args = election_args(case, "cuda", plan)
                _election_check(args, f"phase 2f M={m} {layout} {mode}")
                if layout in ("t=0.3 groups", "fit round") and mode == timed[m]:
                    t = timing[f"M={m} {layout} {mode}"] = _time_election(args)
                    say(f"phase 2f {mode} M={m} {layout}" + _election_timing_text(t))
                if layout == "fit round":
                    replay.append((mode, args))
                del args
            say(
                f"phase 2f leader election == plain: M={m} F={N_FEATURES} {layout} "
                f"({int(case[0].sum())} rejected, {len(np.unique(case[2][case[0]]))} groups with "
                f"rejected rows, {election_pairs(case[0], case[2])} pairs of every row), "
                f"{', '.join(ELECTION_MODES)}"
            )
    for _mode, args in replay:
        _election_replays(args)
    say(
        f"phase 2f leader election == plain on {REPLAYS} replays of a captured call, fit round: "
        f"{', '.join(f'M={a[0].shape[0]} {mode}' for mode, a in replay)}"
    )
    return {"max_abs_err": 0.0, "timing": timing}  # bit-equal, else the phase failed


# The arguments of ``commit_writes`` in order: the tables it updates in
# place, then what it reads
WRITES_TABLES = ("ls", "t_pk", "t_pops", "t_slot", "ls_ref", "n")
WRITES_ARGS = WRITES_TABLES + (
    "group", "pos", "row_ls", "row_pk", "gj_ls", "row_single", "row_n", "aorder", "agrp",
    "committed", "seg_any", "promo", "adder", "ref_promo", "cand_ref", "best_s", "jseg",
    "join_ok", "fits", "create_pool", "ref_create", "create_commit", "created_n",
    "pool_created_n", "cell", "new_slot",
)


def commit_writes_case(rng, m: int, f: int, layout: str) -> dict:
    r"""numpy arguments of one round's pool and tile writes
    (``WRITES_ARGS``), consistent as the round makes them.  Tables: a pool
    of 3M + 2 rows (the first M live, the last the guard, set to -7), tiles
    of Fc = 256 cells (16 where M <= 256) on 2M / Fc + 2 groups, 4M + 4
    cluster slots (their pool refs and counts, the guard slot's -7; the
    candidates among the first half, the new clusters in the second).  Rows:
    sums of 1-4 members, their packed centroids and flags made by the
    buffer rows' producer (``engine/batch.py::_prep_buffer_rows``: a row of
    count 1 whose sums are 0/1 is flagged ``row_single``).  Merge side as
    ``prefix_commit_case``'s keys for ``layout`` ("t=0.3 runs": segments
    of up to thousands of rows; "one segment"; "singletons"; "edges": the
    first with the edges below): 75% of the rows accepted (all in the
    last two), 85% of those committed, each segment's writer its first
    committed row, a promotion where its cluster is a singleton (40% of the
    keys, 70% for "singletons"), else an adder onto the key's own live pool
    row.  Creation side: 35% of the rows create, 90% of them committed;
    joint sums of 1-8 members by segment (M / 4 of them), 60% cohesive, 85%
    fitting their tile; pooled where their count is 2 or more (95% kept),
    pool rows allocated after the promotions, cells distinct outside the
    guard group.  "edges" adds: sums at the vote's edge (2 s == n) in 30% of
    the created rows' columns, counts of 0 and 1 with sums of 2-3 (the
    ``n <= 1`` rule), and writes past capacity (promotions, adders, pooled
    creations, cells, and the slots of three pooled and three committed
    creations).  "mixed" is "t=0.3 runs" with more rows of count 1, half
    of them holding a sum of 2 or -1 (unflagged: every other committed one
    in sorted order, so a segment with two mixes both kinds) and a quarter
    of the flagged own creations voted at a count of 2-3 (the kernel's
    packed cell holds only at counts <= 1).  The
    draws of the other layouts are those of the layouts before the flags
    and "mixed" came, so their data is the same."""
    from bblean_tpu_torch.engine.batch import _prep_buffer_rows

    f8 = (f + 7) // 8
    fc = 16 if m <= 256 else 256
    p_cap, c_cap, g_cap = 3 * m + 2, 2 * m + 2, 2 * m // fc + 2
    i32 = np.int32
    q = np.where(rng.random(f) < 0.25, 0.85, 0.04)
    row_n = rng.integers(1, 5, m)
    layout, mixed = ("t=0.3 runs", True) if layout == "mixed" else (layout, False)
    if mixed:
        row_n = np.where(rng.random(m) < 0.4, 1, row_n)
    row_ls = rng.binomial(row_n[:, None], q, (m, f))
    # Merge side, in the sorted order of the round's candidate keys
    k = m if layout == "singletons" else max(1, m // 8)
    if layout == "singletons":
        key = rng.permutation(m)
    elif layout == "one segment":
        key = np.zeros(m, np.int64)
    else:
        w = 1.0 / np.arange(1, k + 1) ** 1.5
        key = rng.choice(k, m, p=w / w.sum())
    accept = np.ones(m, bool) if layout in ("singletons", "one segment") else rng.random(m) < 0.75
    akey = np.where(accept, key, 1 << 30)
    aorder = np.argsort(akey, kind="stable")
    sk = akey[aorder]
    starts = np.r_[True, sk[1:] != sk[:-1]]
    agrp = np.cumsum(starts) - 1
    acc_s = accept[aorder]
    committed = acc_s & (rng.random(m) < 0.85)
    cum = np.cumsum(committed)
    excl = cum - committed
    run = cum - np.maximum.accumulate(np.where(starts, excl, 0))
    writer = committed & (run == 1)
    single = rng.random(k) < (0.7 if layout == "singletons" else 0.4)
    cand_ref_key = np.where(single, -1, rng.permutation(m)[:k])
    best_key = rng.permutation(c_cap - 1)[:k]
    ks = np.where(acc_s, sk, 0)
    cand_ref = np.where(acc_s, cand_ref_key[ks], rng.integers(-1, m, m))
    best_s = np.where(acc_s, best_key[ks], rng.integers(0, c_cap - 1, m))
    promo = writer & (cand_ref < 0)
    adder = writer & (cand_ref >= 0)
    num_ls = m
    ref_promo = num_ls + np.cumsum(promo) - 1
    # Creation side, in row order
    creator = rng.random(m) < 0.35
    jseg = rng.integers(0, m // 4 + 1, m)
    gj_n = rng.integers(1, 9, m)
    gj_ls = rng.binomial(gj_n[:, None], q, (m, f))
    join_ok = rng.random(m) < 0.6
    fits = rng.random(m) < 0.85
    pool_n = np.where(join_ok, gj_n[jseg], row_n)
    create_pool_try = creator & (pool_n >= 2)
    ref_create = num_ls + promo.sum() + np.cumsum(create_pool_try) - 1
    create_commit = creator & (rng.random(m) < 0.9)
    create_pool = create_pool_try & (rng.random(m) < 0.95)
    created_n = np.where(join_ok & fits, gj_n[jseg], row_n)
    cell = rng.permutation((g_cap - 1) * fc)[:m]
    # The new clusters' slots lie past every drawn slot, as a round's lie
    # past its live clusters (the tables take 2 (2M + 2) slots)
    new_slot = c_cap + np.cumsum(create_commit | create_pool) - 1
    if layout == "edges":
        own = create_commit & ~(join_ok & fits)
        even = own & (row_n % 2 == 0)
        cols = rng.random((m, f)) < 0.3
        row_ls = np.where(even[:, None] & cols, row_n[:, None] // 2, row_ls)
        small = np.flatnonzero(own & (row_n == 1))[:6]
        row_ls[small[:3], :8] = np.array([0, 1, 2, 3, 0, 2, 1, 3])
        created_n[small[3:]] = 0
        row_ls[small[3:], :8] = np.array([3, 0, 1, 2, 0, 0, 2, 1])
        for mask, ref, over in ((promo, ref_promo, p_cap), (adder, cand_ref, p_cap),
                                (create_pool, ref_create, p_cap), (create_commit, cell, g_cap * fc)):
            at = np.flatnonzero(mask)[-3:]
            ref[at] = over + np.arange(len(at))
        for mask in (create_pool, create_commit):
            at = np.flatnonzero(mask)[:3]
            new_slot[at] = 2 * c_cap + np.arange(len(at))
    ls = rng.integers(0, 50, (p_cap, f))
    ls[-1] = -7
    t_pk = rng.integers(0, 256, (g_cap, fc, f8), dtype=np.uint8)
    out = dict(
        ls=ls.astype(i32), t_pk=t_pk,
        t_pops=rng.integers(0, f, (g_cap, fc)).astype(i32),
        t_slot=rng.integers(-1, c_cap, (g_cap, fc)).astype(i32),
        group=rng.integers(0, g_cap - 1, c_cap).astype(i32),
        pos=rng.integers(0, fc, c_cap).astype(i32),
        row_ls=row_ls.astype(i32), gj_ls=gj_ls.astype(i32), aorder=aorder.astype(np.int64),
        agrp=agrp.astype(i32), committed=committed, promo=promo, adder=adder,
        ref_promo=ref_promo.astype(i32), cand_ref=cand_ref.astype(i32), best_s=best_s.astype(i32),
        jseg=jseg.astype(i32), join_ok=join_ok, fits=fits, create_pool=create_pool,
        ref_create=ref_create.astype(i32), create_commit=create_commit,
        created_n=created_n.astype(i32), cell=cell.astype(i32), new_slot=new_slot.astype(i32),
    )
    if mixed:
        ones = aorder[(row_n[aorder] == 1) & committed]
        rest = np.setdiff1d(np.flatnonzero(row_n == 1), ones)
        odd = np.concatenate([ones[::2], rng.permutation(rest)[: len(rest) // 2]])
        at = rng.random((len(odd), f)) < 0.02
        at[np.arange(len(odd)), rng.integers(0, f, len(odd))] = True
        out["row_ls"][odd] = np.where(at, rng.choice([2, -1], at.shape), out["row_ls"][odd])
        own = create_commit & ~(join_ok & fits) & (row_n == 1)
        own[odd] = False
        two = rng.permutation(np.flatnonzero(own))[: max(1, own.sum() // 4)]
        out["created_n"][two] = rng.integers(2, 4, len(two))
    rows = _prep_buffer_rows(torch.from_numpy(out["row_ls"]), torch.from_numpy(row_n.astype(i32)))
    out["row_pk"], out["row_single"] = rows[3].numpy(), rows[5].numpy()
    out["row_n"] = row_n.astype(i32)
    out["seg_any"] = writer
    out["pool_created_n"] = pool_n.astype(i32)
    # The slots past the drawn ones, and every slot's pool ref and count,
    # made without a draw (the guard slot's -7)
    slot = np.arange(2 * c_cap)
    out["group"] = np.concatenate([out["group"], (slot[c_cap:] % (g_cap - 1)).astype(i32)])
    out["pos"] = np.concatenate([out["pos"], (slot[c_cap:] % fc).astype(i32)])
    out["ls_ref"] = np.where(slot % 3 == 0, -1, (slot * 7919) % p_cap).astype(i32)
    out["n"] = (1 + (slot * 31) % 50).astype(i32)
    out["ls_ref"][-1] = out["n"][-1] = -7
    return out


def writes_args(case: dict, device) -> tuple:
    r"""``commit_writes``'s arguments (``WRITES_ARGS``) for ``case`` on
    ``device``: fresh tables each call."""
    return tuple(torch.from_numpy(np.array(case[k], copy=True)).to(device) for k in WRITES_ARGS)


def _writes_reads(args: tuple) -> dict:
    r"""What one call must move, counted from its arguments: rows read
    (committed rows, joint sums, own sums of pooled or created rows; of
    these, the committed and own rows the kernel may read packed), pool
    rows written and read (the adders), promoted cells read, tile cells
    written, pool refs set and counts added.  A write past a table's
    capacity moves nothing."""
    big = WRITES_TABLES + ("group", "pos", "row_ls", "row_pk", "gj_ls")
    a = {k: x.cpu().numpy() for k, x in zip(WRITES_ARGS, args) if k not in big}
    m = args[WRITES_ARGS.index("row_ls")].shape[0]
    p_cap = args[0].shape[0]
    c_cap = args[WRITES_ARGS.index("n")].shape[0]
    n_cells = args[1].shape[0] * args[1].shape[1]
    seg_t = np.full(m, -1)
    writer = a["promo"] | a["adder"]
    tgt = np.where(a["promo"], a["ref_promo"], a["cand_ref"])
    ok_w = writer & (tgt >= 0) & (tgt < p_cap)
    seg_t[a["agrp"][ok_w]] = tgt[ok_w]
    adds = a["committed"] & (seg_t[a["agrp"]] >= 0)
    seg_n = np.zeros(m, bool)
    counted = a["seg_any"] & (a["best_s"] >= 0) & (a["best_s"] < c_cap)
    seg_n[a["agrp"][counted]] = True
    pooled = a["create_pool"] & (a["ref_create"] >= 0) & (a["ref_create"] < p_cap)
    tiles = a["create_commit"] & (a["cell"] >= 0) & (a["cell"] < n_cells)
    joint_rows = set(a["jseg"][pooled & a["join_ok"]]) | set(a["jseg"][tiles & a["join_ok"] & a["fits"]])
    pooled_own = pooled & ~a["join_ok"]
    tiles_own = tiles & ~(a["join_ok"] & a["fits"])
    packed_own = tiles_own & a["row_single"] & (a["created_n"] <= 1) & ~pooled_own
    slot_ok = (a["new_slot"] >= 0) & (a["new_slot"] < c_cap)
    return {
        "committed": int(adds.sum()),
        "committed_packed": int(a["row_single"][a["aorder"][adds]].sum()),
        "joint": len(joint_rows), "own": int((pooled_own | tiles_own).sum()),
        "own_packed": int(packed_own.sum()),
        "promo": int((ok_w & a["promo"]).sum()), "adder": int((ok_w & a["adder"]).sum()),
        "pooled": int(pooled.sum()), "tiles": int(tiles.sum()),
        "refs": int((a["promo"] & counted).sum() + (a["create_pool"] & slot_ok).sum()),
        "counts": int(counted.sum() + (a["create_commit"] & slot_ok).sum()),
        "counted_rows": int((a["committed"] & seg_n[a["agrp"]]).sum()),
    }


def _writes_bound(args: tuple) -> dict:
    r"""The least time for one call of the writes: each committed row read
    once (its F / 8 packed bytes where it is flagged ``row_single``, else
    its 4F bytes of sums), the joint sums and the own sums it copies or
    votes read once (a flagged own creation voted at a count <= 1 its
    packed bytes), each written pool row written once (an adder's read
    too), each promoted candidate's cell read, 256 B + 8 B a written tile
    cell, 4 B a pool ref set and 8 B a count added, and the (M,) inputs
    read once, over 3.35 TB/s.  The vote and the adds are a few
    operations a column, far below the bytes.  ``bound_int32_ms`` is the
    charge before the rows were read packed and before the refs and counts
    were part of the call (every row read as 4F bytes): the bound the
    earlier kernel's shares were taken against."""
    r = _writes_reads(args)
    m, f = args[WRITES_ARGS.index("row_ls")].shape
    f8 = (f + 7) // 8
    row = 4 * f
    common = (r["promo"] + 2 * r["adder"] + r["pooled"]) * row + r["promo"] * f8 + r["tiles"] * (f8 + 8)
    n_bytes = (
        (r["committed"] - r["committed_packed"] + r["joint"] + r["own"] - r["own_packed"]) * row
        + (r["committed_packed"] + r["own_packed"]) * f8
        + common + r["refs"] * 4 + r["counts"] * 8
        + m * (8 + 11 * 4 + 9)
    )
    int32_bytes = (r["committed"] + r["joint"] + r["own"]) * row + common + m * (8 + 10 * 4 + 7)
    return {
        "work": (
            f"M={m} ({r['committed']} committed rows, {r['committed_packed']} of them packed, "
            f"into {r['promo']} promotions + {r['adder']} adders, {r['pooled']} pooled "
            f"creations, {r['tiles']} tile cells, {r['own_packed']} of them copied packed)"
        ),
        "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "bound_int32_ms": int32_bytes / HBM_BYTES_PER_S * 1e3,
    }


def _writes_library(args: tuple):
    r"""The library yardstick's call: ``ls.index_add_`` of the committed
    rows of the adders' segments into their pool rows (the adders' part of
    the writes alone), on ``args``' tensors, its source rows gathered
    beforehand; returns a function that makes the call on a given pool."""
    a = dict(zip(WRITES_ARGS, args))
    m = a["row_ls"].shape[0]
    p_cap = a["ls"].shape[0]
    seg_t = torch.full((m,), -1, dtype=torch.int32, device=a["ls"].device)
    ok = a["adder"] & (a["cand_ref"] >= 0) & (a["cand_ref"] < p_cap)
    seg_t[a["agrp"][ok].long()] = a["cand_ref"][ok]
    t = seg_t[a["agrp"].long()]
    pick = a["committed"] & (t >= 0)
    idx = t[pick].long()
    src = a["row_ls"][a["aorder"][pick]]
    return lambda ls: ls.index_add_(0, idx, src)


def _writes_mixed_segment(case: dict, where: str) -> None:
    r"""A "mixed" case has a merge segment whose committed rows include
    flagged and unflagged rows of count 1 (read packed and as int32 sums
    in one run of the adds), and flagged own cells voted at counts 2-3."""
    rows = case["aorder"][case["committed"]]
    segs = case["agrp"][case["committed"]]
    one = case["row_n"][rows] == 1
    flagged = case["row_single"][rows]
    both = set(segs[one & flagged]) & set(segs[one & ~flagged])
    own = case["create_commit"] & ~(case["join_ok"] & case["fits"]) & case["row_single"]
    if not both or not (own & (case["created_n"] >= 2)).any():
        raise AssertionError(f"{where}: no segment mixes flagged and unflagged rows of count 1")


def _writes_equal(got: tuple, ref: tuple) -> list[str]:
    r"""The names of the tables that differ between two calls' tables."""
    return [n for n, a, b in zip(WRITES_TABLES, got, ref) if not torch.equal(a, b)]


def _writes_check(case_args: tuple, where: str) -> tuple:
    r"""The kernel on fresh tables equals the plain version's tables on
    fresh tables, one launch; the guard row and cell keep their values;
    returns the kernel's tables."""
    from bblean_tpu_torch.ops import commit_writes as cw

    n_tab = len(WRITES_TABLES)
    got = tuple(t.clone() if i < n_tab else t for i, t in enumerate(case_args))
    ref = tuple(t.clone() if i < n_tab else t for i, t in enumerate(case_args))
    before = cw.launches
    cw.commit_writes(*got)
    cw.commit_writes_plain(*ref)
    torch.cuda.synchronize()
    if cw.launches != before + 1:
        raise AssertionError(f"{where}: launches {before} -> {cw.launches}")
    bad = _writes_equal(got, ref)
    if bad:
        raise AssertionError(f"{where}: {', '.join(bad)} differ from the plain version's")
    guards = [(got[0][-1], case_args[0][-1]), (got[1][-1, -1], case_args[1][-1, -1])]
    guards += [(got[i][-1], case_args[i][-1]) for i in (4, 5)]
    if not all(torch.equal(x, y) for x, y in guards):
        raise AssertionError(f"{where}: the guard row, cell or slot changed")
    return got


def _writes_replays(args: tuple) -> None:
    r"""One call captured in a CUDA graph, replayed ``REPLAYS`` times, its
    tables restored before each from the same start (same addresses): each
    replay's tables equal the plain version's."""
    from bblean_tpu_torch.ops import commit_writes as cw

    n_tab = len(WRITES_TABLES)
    start = tuple(t.clone() for t in args[:n_tab])
    ref = tuple(t.clone() for t in args[:n_tab])
    cw.commit_writes_plain(*ref, *args[n_tab:])

    def restore():
        for t, s in zip(args[:n_tab], start):
            t.copy_(s)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        cw.commit_writes(*args)  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        cw.commit_writes(*args)
    for k in range(REPLAYS):
        restore()
        graph.replay()
        torch.cuda.synchronize()
        bad = _writes_equal(args[:n_tab], ref)
        if bad:
            raise AssertionError(f"phase 2g graph replay {k}: {', '.join(bad)} differ from the plain version's")


def _time_writes(args: tuple) -> dict:
    r"""One call of the writes timed (``_time_case``) over copies of its
    arguments in turn (each call writes into its copy's tables again: the
    same work), beside its bound (``_writes_bound``) and the library
    yardstick (``_writes_library``, on the same copies' pools)."""
    from bblean_tpu_torch.ops import commit_writes as cw

    big = sum(args[WRITES_ARGS.index(k)].numel() * 4 for k in ("row_ls", "gj_ls"))
    copies = _copies(args, big)
    take = _in_turn(copies)
    t = _time_case(
        lambda: cw.commit_writes(*take()), lambda: cw.commit_writes_plain(*take()),
        _writes_bound(args), name=WRITES_KERNELS,
    )
    calls = [(c[0], _writes_library(c)) for c in copies]
    pick = _in_turn(calls)

    def library():
        ls, call = pick()
        call(ls)

    t["library_ms"] = _median_ms(library)
    t["copies"] = len(copies)
    return t


def phase_writes() -> dict:
    r"""Phase 2g: the pool and tile writes' kernel (``ops/commit_writes.py``,
    ``csrc/commit_writes.cu``) bit-equal to its plain version (every
    table, the guard row, cell and slot unchanged) in every layout of
    ``WRITES_LAYOUTS`` at 8,192 and 2,048 rows of 2048 bits (segments of
    thousands of rows, split over many blocks; the vote's edge and its
    ``n <= 1`` rule; writes past capacity; flagged and unflagged rows in
    one segment), and at 264 bits (a byte tail, scalar loads); then
    ``REPLAYS`` replays of a captured call.  Timed on the t = 0.3-like
    layout at both widths over copies of the inputs in turn, beside
    ``index_add_`` of the adders' rows (the library yardstick), with both
    bounds (``_writes_bound``).  The kernels line's record is timed on a
    round of the fit (phase 4).  The layouts drawn before "mixed" came
    keep their order, so their data is the same."""
    rng = np.random.default_rng(37)
    timing = {}
    replay = None
    before = [layout for layout in WRITES_LAYOUTS if layout != "mixed"]
    cases = [(m, N_FEATURES, layout) for m in (8192, 2048) for layout in before]
    cases += [(2048, 264, "edges"), (300, 2048, "t=0.3 runs")]
    cases += [(8192, N_FEATURES, "mixed"), (2048, N_FEATURES, "mixed"), (2048, 264, "mixed")]
    for m, f, layout in cases:
        case = commit_writes_case(rng, m, f, layout)
        args = writes_args(case, "cuda")
        _writes_check(args, f"phase 2g M={m} F={f} {layout}")
        _keys, sizes = np.unique(case["agrp"][case["committed"]], return_counts=True)
        r = _writes_reads(args)
        line = (
            f"phase 2g pool and tile writes == plain: M={m} F={f} {layout} ({len(sizes)} merge "
            f"segments, longest {sizes.max() if len(sizes) else 0} committed rows; {r['promo']} "
            f"promotions, {r['adder']} adders, {r['pooled']} pooled creations, {r['tiles']} tile cells; "
            f"{r['committed_packed']} of {r['committed']} committed rows and {r['own_packed']} own "
            f"cells read packed)"
        )
        if layout == "mixed":
            _writes_mixed_segment(case, f"phase 2g M={m} F={f} mixed")
        if layout == "t=0.3 runs" and f == N_FEATURES and m in (8192, 2048):
            t = timing[f"M={m}"] = _time_writes(args)
            line += _timing_text(t) + (
                f" (every row charged as int32 sums {t['bound_int32_ms']:.4g} ms, share "
                f"{t['bound_int32_ms'] / t['ms']:.3f}); index_add_ of the adders' rows "
                f"{t['library_ms']:.4f} ms; over {t['copies']} copies"
            )
            if m == 8192:
                replay = args
        say(line)
    _writes_replays(replay)
    say(f"phase 2g pool and tile writes == plain on {REPLAYS} replays of a captured call")
    return {"max_abs_err": 0.0, "timing": timing}  # bit-equal, else the phase failed


# The arguments of ``refresh_touched`` in order: the tables it updates in
# place, then what it reads
REFRESH_TABLES = ("g_ls", "g_n", "t_pk", "t_pops", "g_cent", "g_pops")
REFRESH_ARGS = REFRESH_TABLES + (
    "ls", "ls_ref", "n", "group", "pos", "assigned", "row_ls", "row_n", "row_pk",
    "row_single", "order",
)
# Phase 2h: the layouts of one step's committed rows (``refresh_case``)
REFRESH_LAYOUTS = (
    "t=0.3 runs", "one hot group", "singleton groups", "overflow", "none", "guard", "edges",
)
# The refresh's kernels as the profiler names them (two launches a call)
REFRESH_KERNELS = ("refresh_fold_kernel", "refresh_vote_kernel")


def refresh_case(rng, m: int, f: int, fc: int, layout: str) -> dict:
    r"""numpy arguments of one step's refresh (``REFRESH_ARGS``), as a step
    leaves them.  Clusters are laid group by group (``per`` a live group, at
    distinct cells of tiles of ``fc`` cells, their slots shuffled), 60% of
    them with a pool row of sums of their 2-50 members, the rest singletons
    of count 1 whose cell holds their bits; other cells hold stale bytes.
    The last group and the last slot are the guards: the guard group's
    tables hold -7 (0xF9 in its tile), the guard slot the engine's zeros.
    Rows: counts of 1 (85%) or 2-4 and their sums, flagged by the buffer
    rows' producer (``engine/batch.py::_prep_buffer_rows``), the last M / 16
    padding (count 0); 80% of the others commit, to a group drawn with
    weights 1 / (i + 1)^1.1 and a cluster of it.  ``order`` is the step's
    sort plan: a stable sort by routed group (padding last), the committed
    group but for "overflow".  Layouts: "t=0.3 runs" (M / 5 live groups of
    8 clusters); "one hot group" (16 groups of 64 clusters, 90% of the
    rows on the first); "singleton groups" (M groups of one cluster, every
    valid row committed to its own group); "overflow" (30% of the committed
    rows sent to clusters of M / 20 more groups while routed to their
    drawn one, as creations into full tiles are); "none" (no row commits);
    "guard" (half the rows commit; the guard slot points at a live cell
    with a pool ref, so that the rows that do not commit gather real
    data); "edges" (pool sums at the vote's edge, 2 s == n, in 30% of
    their columns, pool clusters of counts 0 and 1 with sums of 2-3 and
    singletons of counts 2-3 (the ``n <= 1`` rule and its other side),
    groups of counts 0, 1 and 2^25 + 1 with sums about half of it (f32
    rounding), rows of count 1 holding a sum of 2 or -1 (unflagged))."""
    from bblean_tpu_torch.engine.batch import _prep_buffer_rows

    f8 = (f + 7) // 8
    i32 = np.int32
    g_live, per = {"one hot group": (16, 64), "singleton groups": (m, 1)}.get(
        layout, (max(2, m // 5), 8)
    )
    per = min(per, fc)
    n_over = max(1, m // 20) if layout == "overflow" else 0
    g_used = g_live + n_over
    g_cap = g_used + 2  # an empty group, then the guard
    k = g_used * per
    c_cap = k + 2  # a free slot, then the guard
    q = np.where(rng.random(f) < 0.25, 0.85, 0.04)
    # Clusters: slot -> (group, pos), group-major under a shuffle
    slot_of = rng.permutation(k)
    group = np.zeros(c_cap, np.int64)
    pos = np.zeros(c_cap, np.int64)
    group[slot_of] = np.repeat(np.arange(g_used), per)
    pos[slot_of] = np.concatenate([rng.permutation(fc)[:per] for _ in range(g_used)])
    pooled = np.zeros(c_cap, bool)
    pooled[:k] = rng.random(k) < 0.6
    p_cap = int(pooled.sum()) + 2
    ls_ref = np.full(c_cap, -1, np.int64)
    ls_ref[pooled] = rng.permutation(p_cap - 1)[: pooled.sum()]
    n = np.where(pooled, rng.integers(2, 51, c_cap), 1)
    n[k:] = 0
    ls_rows = np.zeros((p_cap, f), np.int64)
    ls_rows[ls_ref[pooled]] = rng.binomial(n[pooled][:, None], q, (int(pooled.sum()), f))
    ls_rows[-1] = -7
    t_pk = rng.integers(0, 256, (g_cap, fc, f8), dtype=np.uint8)
    t_pops = rng.integers(0, f, (g_cap, fc)).astype(i32)
    g_n = rng.integers(1, 1000, g_cap)
    g_ls = rng.binomial(np.broadcast_to(g_n[:, None], (g_cap, f)), q)
    g_cent = rng.integers(0, 2, (g_cap, f)).astype(np.int8)
    g_pops = rng.integers(0, f, g_cap).astype(i32)
    if layout == "edges":
        edge = pooled & (n % 2 == 0)
        cols = rng.random((c_cap, f)) < 0.3
        ls_rows[ls_ref[edge]] = np.where(cols[edge], n[edge, None] // 2, ls_rows[ls_ref[edge]])
        few = np.flatnonzero(pooled)[:6]
        n[few] = [0, 1, 0, 1, 1, 0]
        ls_rows[ls_ref[few], :8] = np.array([3, 0, 1, 2, 0, 2, 1, 3])
        singles = np.flatnonzero(~pooled[:k])[:4]
        n[singles] = [2, 3, 2, 3]
        g_n[:4] = [0, 1, (1 << 25) + 1, (1 << 25) + 1]
        g_ls[:2, :8] = np.array([3, 0, 1, 2, -1, 2, 1, 0])
        g_ls[2:4] = (1 << 24) + rng.integers(-2, 3, (2, f))
    # The guard group and slot
    g_ls[-1], g_n[-1], g_cent[-1], g_pops[-1] = -7, -7, -7, -7
    t_pk[-1], t_pops[-1] = 0xF9, -7
    group[-1], pos[-1], ls_ref[-1], n[-1] = 0, 0, -1, 0
    if layout == "guard":
        live = np.flatnonzero(pooled[:k])[0]
        group[-1], pos[-1], ls_ref[-1], n[-1] = group[live], pos[live], ls_ref[live], 5
    # Singletons' cells hold their bits
    single = np.flatnonzero(~pooled[:k])
    bits = (rng.random((len(single), f)) < q).astype(np.uint8)
    t_pk[group[single], pos[single]] = np.packbits(bits, axis=1)[:, :f8]
    # Rows
    row_n = np.where(rng.random(m) < 0.85, 1, rng.integers(2, 5, m))
    row_n[m - m // 16:] = 0
    row_ls = rng.binomial(np.maximum(row_n, 1)[:, None], q, (m, f)) * (row_n > 0)[:, None]
    if layout == "edges":
        odd = np.flatnonzero(row_n == 1)[::5]
        at = rng.random((len(odd), f)) < 0.02
        row_ls[odd] = np.where(at, rng.choice([2, -1], at.shape), row_ls[odd])
    valid = row_n > 0
    share = {"none": 0.0, "guard": 0.5, "singleton groups": 1.0}.get(layout, 0.8)
    commit = valid & (rng.random(m) < share)
    w = 1.0 / np.arange(1, g_live + 1) ** 1.1
    if layout == "one hot group":
        w = np.r_[9.0 * w[1:].sum(), w[1:]]
    routed = rng.choice(g_live, m, p=w / w.sum())
    if layout == "singleton groups":
        routed = rng.permutation(m)
    tgt_group = routed.copy()
    if layout == "overflow":
        over = commit & (rng.random(m) < 0.3)
        tgt_group[over] = g_live + rng.integers(0, n_over, over.sum())
    by_group = np.argsort(group[:k], kind="stable")  # slots of group g: by_group[g*per:(g+1)*per]
    pick = by_group[tgt_group * per + rng.integers(0, per, m)]
    assigned = np.where(commit, pick, -1)
    if layout == "edges":
        # The edge clusters are committed to
        edge_slots = np.r_[few, singles]
        assigned[np.flatnonzero(commit)[: len(edge_slots)]] = edge_slots
    routed = np.where(valid, routed, g_cap - 1)
    order = np.argsort(routed, kind="stable")
    out = dict(
        g_ls=g_ls.astype(i32), g_n=g_n.astype(i32), t_pk=t_pk, t_pops=t_pops, g_cent=g_cent,
        g_pops=g_pops, ls=ls_rows.astype(i32), ls_ref=ls_ref.astype(i32), n=n.astype(i32),
        group=group.astype(i32), pos=pos.astype(i32), assigned=assigned.astype(i32),
        row_n=row_n.astype(i32), order=order.astype(np.int64),
    )
    rows = _prep_buffer_rows(torch.from_numpy(row_ls.astype(i32)), torch.from_numpy(out["row_n"]))
    out["row_ls"], out["row_pk"], out["row_single"] = rows[0].numpy(), rows[3].numpy(), rows[5].numpy()
    return out


def refresh_args(case: dict, device) -> tuple:
    r"""``refresh_touched``'s arguments (``REFRESH_ARGS``) for ``case`` on
    ``device``: fresh tables each call."""
    return tuple(torch.from_numpy(np.array(case[k], copy=True)).to(device) for k in REFRESH_ARGS)


def _refresh_reads(args: tuple) -> dict:
    r"""What one call must move, counted from its arguments: the committed
    rows (of them, the flagged ones the kernel reads packed), the distinct
    touched groups, the distinct touched clusters with a pool row and
    without (a singleton: its cell's bytes)."""
    a = dict(zip(REFRESH_ARGS, args))
    assigned = a["assigned"].cpu().numpy()
    c_cap = a["n"].shape[0]
    ok = (assigned >= 0) & (assigned < c_cap)
    slots = np.unique(assigned[ok])
    groups = np.unique(a["group"].cpu().numpy()[slots])
    ref = a["ls_ref"].cpu().numpy()[slots]
    return {
        "committed": int(ok.sum()),
        "committed_packed": int(a["row_single"].cpu().numpy()[ok].sum()),
        "groups": len(groups), "pooled": int((ref >= 0).sum()), "singletons": int((ref < 0).sum()),
    }


def _refresh_bound(args: tuple) -> dict:
    r"""The least time for one call of the refresh: each committed row read
    once (its F / 8 packed bytes where it is flagged ``row_single``, else
    its 4F bytes of sums), each touched group's ``g_ls`` row read, added
    and read again (3 x 4F) with its count, each touched cluster's pool
    row (4F) or, a singleton, its cell (F / 8) read, the touched cells
    (F / 8 + 4) and routing centroids (F + 4) written, and the (M,) inputs
    (assigned, count, flag, order) read once, over 3.35 TB/s.  The votes and
    adds are a few operations a column, far below the bytes."""
    r = _refresh_reads(args)
    m, f = args[REFRESH_ARGS.index("row_ls")].shape
    f8 = (f + 7) // 8
    n_bytes = (
        (r["committed"] - r["committed_packed"]) * 4 * f + r["committed_packed"] * f8
        + r["groups"] * (3 * 4 * f + 8 + f + 4)
        + r["pooled"] * (4 * f + 8) + r["singletons"] * (f8 + 8)
        + (r["pooled"] + r["singletons"]) * (f8 + 4 + 8)
        + m * (4 + 4 + 1 + 8)
    )
    return {
        "work": (
            f"M={m} ({r['committed']} committed rows, {r['committed_packed']} of them packed, "
            f"into {r['groups']} groups; {r['pooled']} pool clusters and {r['singletons']} "
            f"singletons revoted)"
        ),
        "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
    }


def _refresh_equal(got: tuple, ref: tuple) -> list[str]:
    r"""The names of the tables that differ between two calls' tables."""
    return [n for n, a, b in zip(REFRESH_TABLES, got, ref) if not torch.equal(a, b)]


def _refresh_check(case_args: tuple, where: str) -> tuple:
    r"""The kernel on fresh tables equals the plain version's tables on
    fresh tables, one call (two launches); the guard group's rows keep
    their values; returns the kernel's tables.  The kernel runs twice on
    the same start, so its scratch is shown left cleared by a call."""
    from bblean_tpu_torch.ops import refresh as rf

    n_tab = len(REFRESH_TABLES)
    ref = tuple(t.clone() if i < n_tab else t for i, t in enumerate(case_args))
    rf.refresh_touched_plain(*ref)
    for _ in range(2):
        got = tuple(t.clone() if i < n_tab else t for i, t in enumerate(case_args))
        before = rf.launches
        rf.refresh_touched(*got)
        torch.cuda.synchronize()
        if rf.launches != before + 1:
            raise AssertionError(f"{where}: launches {before} -> {rf.launches}")
        bad = _refresh_equal(got, ref)
        if bad:
            raise AssertionError(f"{where}: {', '.join(bad)} differ from the plain version's")
    if not all(torch.equal(g[-1], c[-1]) for g, c in zip(got, case_args[:n_tab])):
        raise AssertionError(f"{where}: the guard group's tables changed")
    return got


def _time_refresh(args: tuple) -> dict:
    r"""One call of the refresh timed (``_time_case``) over copies of its
    arguments in turn (each call folds into its copy's tables again: the
    same work), beside its bound (``_refresh_bound``)."""
    from bblean_tpu_torch.ops import refresh as rf

    big = sum(args[REFRESH_ARGS.index(k)].numel() * 4 for k in ("row_ls", "g_ls"))
    copies = _copies(args, big)
    take = _in_turn(copies)
    t = _time_case(
        lambda: rf.refresh_touched(*take()), lambda: rf.refresh_touched_plain(*take()),
        _refresh_bound(args), name=REFRESH_KERNELS, parts=True,
    )
    t["copies"] = len(copies)
    return t


def phase_refresh() -> dict:
    r"""Phase 2h: the step's refresh kernel (``ops/refresh.py``,
    ``csrc/refresh.cu``) bit-equal to its plain version (every table, the
    guard group unchanged, the scratch left cleared) in every layout of
    ``REFRESH_LAYOUTS`` at 8,192 rows of 2048 bits with tiles of 256 and
    512 cells, at 2,048 rows of 264 bits (scalar loads, no bulk copies)
    and at 300 rows of 100 bits (a byte tail), and timed on "t=0.3 runs"
    and "overflow" at 8,192 rows over copies of the inputs in turn, beside
    its bound (``_refresh_bound``).  The kernels line's record is timed on
    a step of the fit (phase 4)."""
    rng = np.random.default_rng(53)
    timing = {}
    cases = [(8192, N_FEATURES, fc, layout) for fc in (256, 512) for layout in REFRESH_LAYOUTS]
    cases += [(2048, 264, 256, layout) for layout in ("t=0.3 runs", "edges", "overflow")]
    cases += [(300, 100, 16, layout) for layout in ("t=0.3 runs", "edges", "guard")]
    for m, f, fc, layout in cases:
        case = refresh_case(rng, m, f, fc, layout)
        args = refresh_args(case, "cuda")
        _refresh_check(args, f"phase 2h M={m} F={f} Fc={fc} {layout}")
        line = f"phase 2h refresh == plain: M={m} F={f} Fc={fc} {layout}: {_refresh_bound(args)['work']}"
        if f == N_FEATURES and fc == 256 and layout in ("t=0.3 runs", "overflow"):
            t = timing[layout] = _time_refresh(args)
            parts = ", ".join(f"{k} {v:.4f}" for k, v in t["parts_ms"].items())
            line += _timing_text(t) + f" ({parts} ms); over {t['copies']} copies"
        say(line)
    return {"max_abs_err": 0.0, "timing": timing}  # bit-equal, else the phase failed


class _RefreshWork:
    r"""While installed in place of ``engine.batch._refresh_touched``,
    counts the steps' refresh calls (``calls``); with ``plain`` (the plain
    version, uncounted), holds the first three calls and every 25th after
    bit-equal to it on clones of the same tables (``checked``); keeps the
    arguments of call ``keep_at`` on the card, its tables as they were
    before the call (``kept``, in ``REFRESH_ARGS`` order); with ``bounds``,
    notes each call's bound (``_refresh_bound``, which reads the call's
    rows on the host) in ``bound_ms``."""

    def __init__(self, plain=None, keep_at: int | None = None, bounds: bool = False) -> None:
        from bblean_tpu_torch.engine import batch as engine

        self.engine, self.fn, self.plain = engine, engine._refresh_touched, plain
        self.calls = self.checked = 0
        self.keep_at, self.kept = keep_at, None
        self.bounds = bounds
        self.bound_ms: list[float] = []

    def _call(self, state, assigned, row_ls, row_n, row_pk, row_single, order):
        self.calls += 1
        n_tab = len(REFRESH_TABLES)
        args = tuple(getattr(state, k) for k in REFRESH_ARGS[:n_tab + 5]) + (
            assigned, row_ls, row_n, row_pk, row_single, order,
        )
        check = self.plain is not None and (self.calls <= 3 or self.calls % 25 == 0)
        start = tuple(t.clone() for t in args[:n_tab]) if check else None
        if self.calls == self.keep_at:
            self.kept = tuple(t.clone() for t in args)
        if self.bounds:
            self.bound_ms.append(_refresh_bound(args)["bound_ms"])
        out = self.fn(state, assigned, row_ls, row_n, row_pk, row_single, order)
        if check:
            ref = start + args[n_tab:]
            self.plain(*ref)
            torch.cuda.synchronize()
            bad = _refresh_equal(tuple(getattr(out, k) for k in REFRESH_TABLES), ref[:n_tab])
            if bad:
                raise AssertionError(
                    f"refresh call {self.calls} of the fit: {', '.join(bad)} differ from the plain version's"
                )
            self.checked += 1
        return out

    def __enter__(self):
        self.engine._refresh_touched = self._call
        return self

    def __exit__(self, *exc) -> None:
        self.engine._refresh_touched = self.fn


def phase_refresh_fit() -> dict:
    r"""The refresh on the fit path: the 1M x 2048-bit input of phase 4
    through ``BatchTree.fit_packed`` at t = 0.3 and t = 0.65 (phase 4's
    settings), each fit's cluster count exactly the port's own, one kernel
    call (two launches) a step and none of the plain version on CUDA
    tensors, sampled calls held bit-equal to the plain version; then the
    call of the t = 0.3 fit's 60th step timed (``_time_refresh``) beside
    its bound.  ``python3 chip_smoke.py --only refresh`` runs phases 1, 2h
    and this."""
    from bblean_tpu_torch import BatchTree
    from bblean_tpu_torch.fingerprints import make_fake_fingerprints
    from bblean_tpu_torch.ops import refresh as rf

    fps = make_fake_fingerprints(N_FPS, N_FEATURES, seed=SEED)
    dev_fps = torch.from_numpy(fps).to("cuda")
    del fps
    kept = None
    launches = 0
    for thr in (0.3, 0.65):
        with _PlainOnCuda() as plain:
            original = plain.round_plain[(rf, "refresh_touched_plain")]
            with _RefreshWork(original, keep_at=60 if thr == 0.3 else None) as work:
                _reset_counts()
                before = rf.launches
                t0 = time.perf_counter()
                tree = BatchTree(
                    N_FEATURES, threshold=thr, batch_size=8192, device="cuda",
                    **FIT_SETTINGS[thr],
                )
                tree.fit_packed(dev_fps, range(N_FPS))
                ncl = tree.num_clusters
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            plain.check(f"the refresh fit t={thr}")
        calls = rf.launches - before
        launches += calls
        say(
            f"phase 2h fit t={thr}: {wall:.2f} s, {ncl} clusters (port's count "
            f"{PORT_COUNTS[thr]}), {work.calls} refresh calls, {calls} kernel calls "
            f"(two launches each), {work.checked} held == plain; groups {tree.num_groups}"
        )
        if ncl != PORT_COUNTS[thr]:
            raise AssertionError(f"cluster count {ncl} is not the port's {PORT_COUNTS[thr]}")
        if calls != work.calls or work.checked < 3:
            raise AssertionError(f"{work.calls} refresh calls, {calls} kernel calls, {work.checked} held")
        if work.kept is not None:
            kept = work.kept
        del tree
        torch.cuda.empty_cache()
    del dev_fps
    t = _time_refresh(kept)
    parts = ", ".join(f"{k} {v:.4f}" for k, v in t["parts_ms"].items())
    say(
        f"phase 2h refresh at the t = 0.3 fit's 60th step:" + _timing_text(t)
        + f" ({parts} ms); over {t['copies']} copies"
    )
    return {"max_abs_err": 0.0, "timing": {"fit": t}, "launches": launches}


def _only_refresh() -> None:
    r"""Phases 1, 2h and the refresh's fits alone (no kernels line, no
    result line)."""
    phase_device()
    phase_refresh()
    phase_refresh_fit()


def _reset_counts() -> None:
    from bblean_tpu_torch.ops import (
        commit_writes, leader_election, prefix_commit, refresh, route, tile_search as ts,
    )

    ts.launches = 0
    ts.row_launches = 0
    ts.generic_launches = 0
    ts.plan_launches = 0
    route.route_launches = 0
    route.best_sim_launches = 0
    route.generic_launches = 0
    route.wgmma_launches = 0
    prefix_commit.launches = 0
    leader_election.launches = 0
    commit_writes.launches = 0
    refresh.launches = 0


def _counts() -> tuple[int, int, int]:
    from bblean_tpu_torch.ops import tile_search as ts

    return ts.launches, ts.row_launches, ts.plan_launches


def _route_counts() -> tuple[int, int, int, int]:
    r"""Launches of the route kernels: (route, twin, generic path, TMA
    path); every launch of the route or the twin takes one of the paths."""
    from bblean_tpu_torch.ops import route

    return (
        route.route_launches, route.best_sim_launches, route.generic_launches,
        route.wgmma_launches,
    )


def _kernel_counts() -> tuple[int, int, int, int, int]:
    r"""Launches of the route, its twin, the prefix-commit kernel, the
    leader election and the pool and tile writes."""
    from bblean_tpu_torch.ops import commit_writes, leader_election, prefix_commit, route

    return (
        route.route_launches, route.best_sim_launches, prefix_commit.launches,
        leader_election.launches, commit_writes.launches,
    )


# A phase's launches of every kernel of the kernels line
LAUNCH_KEYS = (
    "sorted", "rows", "plan", "route", "twin", "prefix-commit", "leader-election",
    "commit-writes",
)


def _add_launches(launches: dict) -> tuple[int, int, int]:
    r"""Add the counts since the last ``_reset_counts()`` to ``launches``;
    returns the route kernels' (route, twin, generic path)."""
    for k, c in zip(LAUNCH_KEYS, _counts() + _kernel_counts()):
        launches[k] += c
    return _route_counts()[:3]


def _check_prefix_launches(what: str, rounds: int | None = None) -> int:
    r"""A run that inserts rows must launch the prefix-commit kernel, three
    times an insert round where ``rounds`` counts them, and the leader
    election and the pool and tile writes, once a round (the diameter
    criterion elects in every round); returns the prefix-commit kernel's
    launches since the last ``_reset_counts()``."""
    from bblean_tpu_torch.ops import commit_writes, leader_election, prefix_commit

    n = prefix_commit.launches
    per_round = {
        "prefix-commit": (n, 3), "leader-election": (leader_election.launches, 1),
        "commit-writes": (commit_writes.launches, 1),
    }
    for name, (got, k) in per_round.items():
        if got <= 0 or (rounds is not None and got != k * rounds):
            raise AssertionError(
                f"{what}: {got} {name} launches" + (f" for {rounds} insert rounds" if rounds else "")
            )
    return n


def _check_route_launches(n: int, generic: int, what: str) -> None:
    r"""A main-path run must launch the route (or twin) kernel, never on
    the generic path: every route and twin launch since the last
    ``_reset_counts()`` took the TMA path (``wgmma_launches``)."""
    if n <= 0 or generic:
        raise AssertionError(f"{what}: {n} route kernel launches, {generic} on the generic path")
    _check_tma_path(what)


def _check_tma_path(what: str) -> None:
    r"""Every route and twin launch since the last ``_reset_counts()``
    went through the TMA kernel (none the generic ``mma.sync`` path)."""
    n_route, n_twin, generic, tma = _route_counts()
    if generic or tma != n_route + n_twin:
        raise AssertionError(
            f"{what}: {n_route} route + {n_twin} twin launches, {tma} on the TMA path, "
            f"{generic} on the generic path"
        )


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
    r"""Counts calls of the plain versions on CUDA tensors (they must see
    none) while installed in place of ``tile_search.search_tiles_plain``,
    through which both tile-search wrappers reach the plain search, of
    ``route.route_groups_plain`` and ``route.best_group_sim_plain``, through
    which the route's wrappers reach theirs, of
    ``prefix_commit.prefix_commit_moments_plain``, and of
    ``leader_election.elect_leaders_plain``,
    ``commit_writes.commit_writes_plain`` and
    ``refresh.refresh_touched_plain``.  ``self.plain`` and
    ``self.route_plain`` are the uncounted originals."""

    def __init__(self) -> None:
        from bblean_tpu_torch.ops import prefix_commit, route, tile_search as ts

        self.ts, self.plain, self.calls = ts, ts.search_tiles_plain, 0
        self.route = route
        self.route_plain = {
            "route_groups_plain": route.route_groups_plain,
            "best_group_sim_plain": route.best_group_sim_plain,
        }
        self.route_calls = dict.fromkeys(self.route_plain, 0)
        self.prefix, self.prefix_plain = prefix_commit, prefix_commit.prefix_commit_moments_plain
        self.prefix_calls = 0
        from bblean_tpu_torch.ops import commit_writes, leader_election, refresh

        # The round's and the step's other plain versions: (module, name) ->
        # original
        self.round_plain = {
            (leader_election, "elect_leaders_plain"): leader_election.elect_leaders_plain,
            (commit_writes, "commit_writes_plain"): commit_writes.commit_writes_plain,
            (refresh, "refresh_touched_plain"): refresh.refresh_touched_plain,
        }
        self.round_calls = dict.fromkeys(self.round_plain, 0)

    def __call__(self, row_pk, *args):
        self.calls += row_pk.device.type == "cuda"
        return self.plain(row_pk, *args)

    def _counted(self, name: str):
        fn = self.route_plain[name]

        def call(rows, *args):
            self.route_calls[name] += rows.device.type == "cuda"
            return fn(rows, *args)

        return call

    def _prefix_counted(self, criterion, row_ls, *args):
        self.prefix_calls += row_ls.device.type == "cuda"
        return self.prefix_plain(criterion, row_ls, *args)

    def _round_counted(self, key):
        fn = self.round_plain[key]

        def call(first, *args):
            self.round_calls[key] += first.device.type == "cuda"
            return fn(first, *args)

        return call

    def __enter__(self):
        self.ts.search_tiles_plain = self
        for name in self.route_plain:
            setattr(self.route, name, self._counted(name))
        self.prefix.prefix_commit_moments_plain = self._prefix_counted
        for key in self.round_plain:
            setattr(*key, self._round_counted(key))
        return self

    def __exit__(self, *exc) -> None:
        self.ts.search_tiles_plain = self.plain
        for name, fn in self.route_plain.items():
            setattr(self.route, name, fn)
        self.prefix.prefix_commit_moments_plain = self.prefix_plain
        for key, fn in self.round_plain.items():
            setattr(*key, fn)

    def check(self, what: str) -> None:
        if self.calls:
            raise AssertionError(f"the plain search ran on CUDA tensors during {what}")
        if self.prefix_calls:
            raise AssertionError(f"the plain prefix commits ran on CUDA tensors during {what}")
        ran = [name for name, n in self.route_calls.items() if n]
        ran += [name for (_mod, name), n in self.round_calls.items() if n]
        if ran:
            raise AssertionError(f"{' and '.join(ran)} ran on CUDA tensors during {what}")


class _RouteWork:
    r"""While installed, records the shape of every call of the route's
    wrappers, as (rows, table groups, live groups) per kind ("route",
    "twin"), and holds the first three calls of each kind and every 25th
    after bit-equal to the plain version on the same inputs (the uncounted
    originals of ``plain``, a :class:`_PlainOnCuda`).  The wrapper's own
    launch is the main path's; the plain version launches no kernel."""

    def __init__(self, plain: _PlainOnCuda) -> None:
        route = plain.route
        self.route = route
        self.fns = {"route": route.route_groups, "twin": route.best_group_sim}
        self.plains = {
            "route": plain.route_plain["route_groups_plain"],
            "twin": plain.route_plain["best_group_sim_plain"],
        }
        self.seen = {"route": [], "twin": []}
        self.checked = {"route": 0, "twin": 0}

    def _wrap(self, kind: str):
        fn, plain = self.fns[kind], self.plains[kind]

        def call(rows, *args):
            got = fn(rows, *args)
            self.seen[kind].append((rows.shape[0], args[1].shape[0], args[3]))
            n = len(self.seen[kind])
            if n <= 3 or n % 25 == 0:
                ref = plain(rows, *args)
                torch.cuda.synchronize()
                if not torch.equal(got.view(torch.int32), ref.view(torch.int32)):
                    raise AssertionError(f"a {kind} launch on the main path differs from the plain version")
                self.checked[kind] += 1
            return got

        return call

    def mean(self, kind: str) -> tuple[float, float, float]:
        r"""Mean (rows, table groups, live groups) of the calls of ``kind``."""
        got = np.asarray(self.seen[kind], dtype=np.float64).reshape(-1, 3)
        return tuple(got.mean(0)) if len(got) else (0.0, 0.0, 0.0)

    def text(self, kind: str) -> str:
        m, g_cap, g_num = self.mean(kind)
        return (
            f"{len(self.seen[kind])} {kind} calls (average M {m:.0f}, table {g_cap:.0f}, "
            f"live groups {g_num:.1f}; {self.checked[kind]} held == plain)"
        )

    def __enter__(self):
        self.route.route_groups = self._wrap("route")
        self.route.best_group_sim = self._wrap("twin")
        return self

    def __exit__(self, *exc) -> None:
        self.route.route_groups = self.fns["route"]
        self.route.best_group_sim = self.fns["twin"]


# The ring of ``_PrefixWork``'s log on each card: (rows read, longest
# run) of each launch, written by every program captured under a log for
# as long as the program lives, so it is never freed
_PREFIX_LOG: dict = {}
PREFIX_LOG_CAP = 1 << 16


class _PrefixWork:
    r"""While installed, logs every launch of the prefix-commit kernel,
    launches inside replayed CUDA graphs included.  On the host, each
    launch's (M, F, moments, call, logged), the call being "screen", "pass
    1" or "pass 2" in a round's order: a capture notes them in the program
    (``graphs.capturing.notes``), each replay adds them to ``seen``.  With
    ``log``, on the card too, by ops that a capture takes into its graph:
    the rows the call's mask lets in, its longest run (a segment's rows
    from its start to the last of them in the mask), the rows in ``need``
    and the rows of ``row_ls`` the result depends on (``_prefix_reads``),
    into ``_PREFIX_LOG``.  The log costs about a dozen small kernels a
    launch, so a profiled fit runs without it.  :meth:`bound_ms` sums the
    calls' bounds (``_prefix_bound``, from the logged rows; ``full``: with
    ``cand_ls`` charged whole and ``row_ls`` for the mask's rows),
    :meth:`traffic` gives their masks, needed rows and runs.  While
    ``sampling`` is set (a comparison's run, off the fit's counts), a call
    is not logged; the first call of each (M, call) is copied to the host
    into ``samples``, and so is the first call of the leader election and
    of the pool and tile writes at each M (keys ("election", M) and
    ("writes", M); the writes' four tables as their shapes and dtypes,
    to be made again as zeros).  With ``first``, the fit's first call of
    the election (a dispatched wide round of the first batch: every row on
    one group) is copied too (key ("election", "first"))."""

    def __init__(self, log: bool = True, first: bool = False) -> None:
        from bblean_tpu_torch.engine import graphs
        from bblean_tpu_torch.ops import prefix_commit as pc
        from bblean_tpu_torch.ops.merges import moment_count

        try:
            from bblean_tpu_torch.ops import commit_writes as cw, leader_election as le
        except ImportError:  # a checkout without those kernels (chip_ab.py's other)
            cw = le = None

        self.graphs, self.pc, self.launch = graphs, pc, pc._launch
        self.le, self.cw = le, cw
        if le is not None:
            self.le_launch, self.cw_launch = le._launch, cw._launch
        self.moment_count = moment_count
        self.log = log
        self.first = first
        self.seen: list[tuple[int, int, int, str, bool]] = []
        self.samples: dict[tuple[int, str], tuple] = {}
        self.sampling = False
        self._pass = 1
        self._start = 0
        self._rows = None

    def _log_rows(self, row_ls, mask, seg_start, need) -> None:
        ring, cursor = _PREFIX_LOG[row_ls.device]
        m = row_ls.shape[0]
        dev = row_ls.device

        def count(rows):
            if rows is None:
                return torch.full((), m, dtype=torch.int64, device=dev)
            return rows.sum(dtype=torch.int64)

        in_mask, needed = count(mask), count(need)
        read = in_mask
        if seg_start is None and need is not None:
            read = count(need if mask is None else mask & need)
        if seg_start is None:
            run = torch.ones((), dtype=torch.int64, device=dev)
        else:
            run = torch.arange(1, m + 1, device=dev) - seg_start
            run = (run if mask is None else torch.where(mask, run, 0)).max()
        row = torch.stack([in_mask, run, needed, read])[None]
        ring.index_copy_(0, cursor.remainder(PREFIX_LOG_CAP), row)
        cursor.add_(1)

    def _record(self, criterion, row_ls, cand_ls, new_n, old_n, order, mask, seg_start,
                need=None):
        args = (criterion, row_ls, cand_ls, new_n, old_n, order, mask, seg_start, need)
        n_mom = self.moment_count(criterion)
        if n_mom and row_ls.numel():
            if seg_start is None:
                call, self._pass = "screen", 1
            else:
                call, self._pass = f"pass {self._pass}", self._pass + 1
            m, f = row_ls.shape
            if self.sampling:
                self.samples.setdefault((m, call), tuple(
                    a.cpu() if isinstance(a, torch.Tensor) else a for a in args
                ))
            else:
                if self.log:
                    self._log_rows(row_ls, mask, seg_start, need)
                note = (m, f, n_mom, call, self.log)
                if self.graphs.capturing is not None:
                    self.graphs.capturing.notes.setdefault("prefix", []).append(note)
                else:
                    self.seen.append(note)
        # A checkout whose wrapper takes no ``need`` is called without it
        return self.launch(*(args if need is not None else args[:8]))

    def _replayed(self, prog, stage: str) -> None:
        if stage == "after":
            self.seen.extend(prog.notes.get("prefix", ()))

    def _sample_election(self, *args):
        if self.sampling:
            self.samples.setdefault(("election", args[0].shape[0]), _to_host(args))
        elif self.first and self.graphs.capturing is None:
            self.samples.setdefault(("election", "first"), _to_host(args))
        return self.le_launch(*args)

    def _sample_writes(self, *args):
        if self.sampling:
            n_tab = len(WRITES_TABLES)
            tables = tuple(("zeros", tuple(t.shape), t.dtype) for t in args[:n_tab])
            m = args[WRITES_ARGS.index("row_ls")].shape[0]
            self.samples.setdefault(("writes", m), tables + _to_host(args[n_tab:]))
        return self.cw_launch(*args)

    def rows(self) -> np.ndarray:
        r"""(launches, 4): each launch's rows in the mask, longest run, rows
        in ``need`` and rows of ``row_ls`` read, in the order of
        ``seen``."""
        if self._rows is None:
            if not all(note[4] for note in self.seen):
                raise AssertionError("a prefix-commit launch ran in a program captured without the log")
            torch.cuda.synchronize()
            ring, cursor = _PREFIX_LOG[torch.device("cuda", torch.cuda.current_device())]
            end = int(cursor.item())
            if end - self._start != len(self.seen) or len(self.seen) > PREFIX_LOG_CAP:
                raise AssertionError(
                    f"{end - self._start} prefix-commit launches logged on the card, "
                    f"{len(self.seen)} on the host"
                )
            self._rows = ring[torch.arange(self._start, end) % PREFIX_LOG_CAP].cpu().numpy()
        return self._rows

    def bound_ms(self, full: bool = False) -> float:
        return sum(
            _prefix_bound(m, f, n_mom, call != "screen", int(in_mask))["bound_ms"] if full
            else _prefix_bound(m, f, n_mom, call != "screen", int(read), int(needed))["bound_ms"]
            for (m, f, n_mom, call, _logged), (in_mask, _run, needed, read)
            in zip(self.seen, self.rows())
        )

    def traffic(self) -> dict:
        r"""Per (M, call): launches, and the quartiles of the mask's share
        of the rows, of the needed rows' share and of the longest run."""
        rows = self.rows()
        out = {}
        for key in sorted({(n[0], n[3]) for n in self.seen}, key=lambda k: (-k[0], k[1])):
            pick = np.array([(n[0], n[3]) == key for n in self.seen])
            q = (25, 50, 75)
            out[f"M={key[0]} {key[1]}"] = {
                "launches": int(pick.sum()),
                "mask_share": [float(v) for v in np.percentile(rows[pick, 0] / key[0], q)],
                "need_share": [float(v) for v in np.percentile(rows[pick, 2] / key[0], q)],
                "longest_run": [float(v) for v in np.percentile(rows[pick, 1], q)],
            }
        return out

    def traffic_text(self) -> str:
        def q(v, fmt):
            return "/".join(format(x, fmt) for x in v)

        return "; ".join(
            f"{k}: {v['launches']} launches, mask share {q(v['mask_share'], '.3f')}, need share "
            f"{q(v['need_share'], '.3f')}, longest run {q(v['longest_run'], '.0f')} (quartiles)"
            for k, v in self.traffic().items()
        )

    def __enter__(self):
        if self.log:
            dev = torch.device("cuda", torch.cuda.current_device())
            if dev not in _PREFIX_LOG:
                _PREFIX_LOG[dev] = (
                    torch.zeros((PREFIX_LOG_CAP, 4), dtype=torch.int64, device=dev),
                    torch.zeros((1,), dtype=torch.int64, device=dev),
                )
            torch.cuda.synchronize()
            self._start = int(_PREFIX_LOG[dev][1].item())
        self.pc._launch = self._record
        if self.le is not None:
            self.le._launch, self.cw._launch = self._sample_election, self._sample_writes
        self.graphs.observers.append(self._replayed)
        return self

    def __exit__(self, *exc) -> None:
        self.pc._launch = self.launch
        if self.le is not None:
            self.le._launch, self.cw._launch = self.le_launch, self.cw_launch
        self.graphs.observers.remove(self._replayed)


def _to_host(args):
    r"""A call's arguments copied to the host (tuples within, None kept)."""
    if isinstance(args, torch.Tensor):
        return args.cpu()
    if isinstance(args, tuple):
        return tuple(_to_host(a) for a in args)
    return args


def _to_card(args, device="cuda"):
    r"""A sample's arguments on the card: tensors copied, tables given as
    ("zeros", shape, dtype) made as zeros."""
    if isinstance(args, torch.Tensor):
        return args.to(device)
    if isinstance(args, tuple) and args and isinstance(args[0], str):
        return torch.zeros(args[1], dtype=args[2], device=device)
    if isinstance(args, tuple):
        return tuple(_to_card(a, device) for a in args)
    return args


class _ReplayTwin:
    r"""While installed (an observer of ``engine/graphs.py``), holds one
    sampled replay of each round program (the ``at``-th replay of a wide
    and of a narrow round) bit-equal to the same round run dispatched on a
    clone of the state: before the replay the program's tables and buffers
    are cloned; after it the program's function runs on the clones and
    every output and every table must equal the replay's.  The clone's
    launches are a comparison's and are taken back from the counts; the
    peak allocated before the clone is kept in ``peak`` and the peak is
    reset after it, so the fit's own peak is ``max(peak, the peak after)``.
    With ``prefix`` (a ``_PrefixWork``), the dispatched run samples the
    round's prefix-commit calls into ``prefix.samples``."""

    def __init__(self, at: dict | None = None, prefix: "_PrefixWork | None" = None) -> None:
        from bblean_tpu_torch.engine import batch as engine, graphs
        from bblean_tpu_torch.ops import _kernel

        self.engine, self.graphs, self.counters = engine, graphs, _kernel.counters
        self.at = at or {"wide": 5, "narrow": 2}
        self.prefix = prefix
        self.seen = dict.fromkeys(self.at, 0)
        self.held: list[str] = []
        self.peak = 0
        self._clone = None

    def __call__(self, prog, stage: str) -> None:
        kind = prog.key[0][0]
        if kind not in self.at:
            return
        if stage == "before":
            self.seen[kind] += 1
            if self.seen[kind] == self.at[kind]:
                self.peak = max(self.peak, torch.cuda.max_memory_allocated())
                self._clone = (
                    tuple(t.clone() for t in prog.tables()),
                    self.graphs.Buffers((k, v.clone()) for k, v in prog.bufs.items()),
                )
            return
        if self._clone is None:
            return
        tables, bufs = self._clone
        self._clone = None
        counters = [(m, n, getattr(m, n)) for m, n in self.counters]
        if self.prefix is not None:
            self.prefix.sampling = True
        try:
            out = prog.fn(tables, bufs)
        finally:
            if self.prefix is not None:
                self.prefix.sampling = False
        for m, n, v in counters:
            setattr(m, n, v)
        torch.cuda.synchronize()
        bad = [f"output {i}" for i, (a, b) in enumerate(zip(out, prog.outputs)) if not torch.equal(a, b)]
        bad += [
            name for name, a, b in zip(self.engine._TABLES, tables, prog.tables())
            if not torch.equal(a, b)
        ]
        if bad or len(out) != len(prog.outputs):
            raise AssertionError(
                f"replay {self.seen[kind]} of a {kind} round differs from the same round "
                f"dispatched on a clone of the state: {', '.join(bad)}"
            )
        rows = prog.key[0][2] if kind == "narrow" else prog.bufs["row_n"].shape[0]
        self.held.append(f"{kind} (replay {self.seen[kind]}, {rows} rows)")
        del tables, bufs, out
        torch.cuda.reset_peak_memory_stats()

    def __enter__(self):
        self.graphs.observers.append(self)
        return self

    def __exit__(self, *exc) -> None:
        self.graphs.observers.remove(self)


class _Rounds:
    r"""While installed, counts the insert rounds a run executes: the calls
    of ``graphs.run`` for a wide or a narrow round (each runs its round
    once, dispatched at its key's first use or replayed after)."""

    def __init__(self) -> None:
        from bblean_tpu_torch.engine import graphs

        self.graphs, self.run, self.n = graphs, graphs.run, 0

    def _run(self, name, *args):
        self.n += name[0] in ("wide", "narrow")
        return self.run(name, *args)

    def __enter__(self):
        self.graphs.run = self._run
        return self

    def __exit__(self, *exc) -> None:
        self.graphs.run = self.run


def _graph_counts() -> tuple[int, int, int]:
    r"""Programs of ``engine/graphs.py`` so far: (run dispatched at their
    first use, captured, replayed)."""
    from bblean_tpu_torch.engine import graphs

    return graphs.warmups, graphs.captures, graphs.replays


# Peaks allocated before the rounds were graphed: the 1M fits (the t = 0.65
# fit with the t = 0.3 tree kept, as here), and the eight-shard fit + merge
# of phase 8 b (PERF.md §5)
PEAK_BEFORE_GIB = {0.3: 4.65, 0.65: 9.05, "8 shards": 19.23}
# The replays of phase 4's t = 0.3 fit that ``_ReplayTwin`` holds to a
# dispatched run: about the middle of its 145 wide and 204 narrow rounds
REPLAY_AT = {"wide": 70, "narrow": 100}


def phase_full_size() -> dict:
    from bblean_tpu_torch.fingerprints import make_fake_fingerprints
    from bblean_tpu_torch import BatchTree
    from bblean_tpu_torch.engine import batch as engine

    t0 = time.perf_counter()
    fps = make_fake_fingerprints(N_FPS, N_FEATURES, seed=SEED)
    dev_fps = torch.from_numpy(fps).to("cuda")
    torch.cuda.synchronize()
    say(f"phase 4 input: {N_FPS} x {N_FEATURES}-bit fps staged on the card in {time.perf_counter() - t0:.1f} s")

    launches = dict.fromkeys(LAUNCH_KEYS, 0)
    kept = None
    fit_walls = {}
    prefix_samples = {}
    with _PlainOnCuda() as plain:
        for thr in (0.3, 0.65):
            torch.cuda.reset_peak_memory_stats()
            syncs0 = engine.host_syncs
            graphs0 = _graph_counts()
            _reset_counts()
            t0 = time.perf_counter()
            # The t = 0.3 fit also holds one replayed wide and narrow round
            # to the same round dispatched on a clone of the state, whose
            # prefix-commit calls are sampled, and logs the traffic of its
            # prefix commits
            with (
                _RouteWork(plain) as work, _Rounds() as rounds,
                _PrefixWork(first=True) if thr == 0.3 else contextlib.nullcontext() as prefix,
                _ReplayTwin(REPLAY_AT, prefix) if thr == 0.3 else contextlib.nullcontext() as twin,
            ):
                tree = BatchTree(
                    N_FEATURES, threshold=thr, batch_size=8192, device="cuda",
                    **FIT_SETTINGS[thr],
                )
                tree.fit_packed(dev_fps, range(N_FPS))
                ncl = tree.num_clusters
                torch.cuda.synchronize()
            wall = fit_walls[thr] = time.perf_counter() - t0
            n_sorted, n_rows, n_plan = _counts()
            n_route, n_twin, route_generic = _add_launches(launches)
            n_prefix = _check_prefix_launches(f"phase 4 t={thr}", rounds.n)
            from bblean_tpu_torch.ops import tile_search as ts

            n_generic = ts.generic_launches
            syncs = engine.host_syncs - syncs0
            warm, cap, rep = (b - a for a, b in zip(graphs0, _graph_counts()))
            peak = max(twin.peak if twin else 0, torch.cuda.max_memory_allocated()) / 2**30
            rel = (ncl - JAX_COUNTS[thr]) / JAX_COUNTS[thr]
            say(
                f"phase 4 t={thr}: fit {wall:.2f} s, {N_FPS / wall:.0f} fps/s, "
                f"{ncl} clusters (port's count {PORT_COUNTS[thr]}; JAX record "
                f"{JAX_COUNTS[thr]}, rel diff {rel:+.5%}), {syncs} host syncs, "
                f"kernel launches {n_sorted} sorted + {n_rows} per-row "
                f"({n_generic} on the generic path) + {n_plan} plan + {n_route} route "
                f"+ {n_twin} twin ({route_generic} generic) + {n_prefix} prefix-commit "
                f"(3 x {rounds.n} insert rounds), peak "
                f"{peak:.2f} GiB allocated (before graphed rounds {PEAK_BEFORE_GIB[thr]:.2f}), "
                f"{torch.cuda.max_memory_reserved() / 2**30:.2f} GiB reserved; "
                f"{work.text('route')}, final groups {tree.num_groups}"
            )
            say(
                f"phase 4 t={thr}: programs (rounds and split passes): {warm} run dispatched "
                f"at their first use, {cap} captured, {rep} replayed; {syncs} host syncs; "
                f"peak {peak:.2f} GiB allocated"
                + (f"; replayed rounds == dispatched on a clone: {', '.join(twin.held)}" if twin else "")
            )
            if rep <= 0 or cap > warm:
                raise AssertionError(f"phase 4 t={thr}: {warm} warm-ups, {cap} captures, {rep} replays")
            if twin and len(twin.held) != len(twin.at):
                raise AssertionError(f"phase 4: only {twin.held} of the sampled replays were held")
            if prefix:
                if len(prefix.seen) != n_prefix:
                    raise AssertionError(
                        f"phase 4: {len(prefix.seen)} prefix-commit launches logged, {n_prefix} counted"
                    )
                say(
                    f"phase 4 t={thr} prefix-commit traffic (logged on the card, every launch): "
                    f"{prefix.traffic_text()}; bounds summed over the fit's launches "
                    f"{prefix.bound_ms():.3f} ms ({prefix.bound_ms(full=True):.3f} ms with "
                    f"cand_ls read whole)"
                )
                prefix_samples = prefix.samples
            if n_sorted <= 0 or n_plan <= 0:
                raise AssertionError("the fit never launched the sorted search or the plan kernel")
            if n_generic:
                raise AssertionError(f"the fit took the generic path {n_generic} times")
            _check_route_launches(n_route, route_generic, "the fit")
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
        # Run (a)'s directory of phase 6 is kept for phase 10
        with tempfile.TemporaryDirectory(prefix="bb-smoke-") as tmp:
            phase6, run_dir = phase_cli(fps, fit_walls, plain, Path(tmp))
            phase8 = phase_sharded(fps, plain)
            phase9 = phase_bitbirch(fps, plain)
            phase_side_ops(centroids)
            phase_analysis(run_dir)
    return {
        "launches": {
            k: launches[k] + phase5[k] + phase6[k] + phase8[k] + phase9[k]
            for k in launches
        },
        "prefix_samples": prefix_samples,
    }


def _election_fit(samples: dict, device="cuda") -> dict:
    r"""The leader elections phase 4 sampled (the mid-fit wide and narrow
    rounds' calls and the fit's first, every row on one group) held to
    the plain version and timed; returns the timings by call."""
    timing = {}
    for key, name in ((8192, "M=8192"), (2048, "M=2048"), ("first", "first round")):
        args = _to_card(samples[("election", key)], device)
        _election_check(args, f"phase 4 leader election, {name} of the fit")
        t = timing[name] = _time_election(args)
        say(f"phase 4 leader election == plain on the t=0.3 fit's {name}" + _election_timing_text(t))
        del args
        torch.cuda.empty_cache()
    return timing


def phase_prefix_fit(samples: dict) -> dict:
    r"""The prefix-commit calls of one wide and one narrow round of phase
    4's t = 0.3 fit (the rounds its ``_ReplayTwin`` ran again, about the
    middle of the fit), held bit-equal to the plain version and timed as
    in phase 2e (``_time_prefix``): the traffic of a real round.  The
    same rounds' leader elections and pool and tile writes, and the fit's
    first election, are held and timed as in phases 2f and 2g."""
    from bblean_tpu_torch.ops import prefix_commit as pc

    want = {(m, call) for m in (8192, 2048) for call in ("screen", "pass 1", "pass 2")}
    want |= {(kind, m) for kind in ("election", "writes") for m in (8192, 2048)}
    want.add(("election", "first"))
    if set(samples) != want:
        raise AssertionError(f"phase 4 sampled the calls {sorted(samples, key=str)}, not {sorted(want, key=str)}")
    timing = {}
    prefix_samples = {k: v for k, v in samples.items() if isinstance(k[0], int)}
    for (m, call), args in sorted(prefix_samples.items(), key=lambda kv: (-kv[0][0], kv[0][1])):
        args = tuple(a.to("cuda") if isinstance(a, torch.Tensor) else a for a in args)
        if not torch.equal(pc.prefix_commit_moments(*args), pc.prefix_commit_moments_plain(*args)):
            raise AssertionError(f"phase 4 prefix commits, round of the fit M={m} {call}: kernel != plain")
        t = timing[f"M={m} {call}"] = _time_prefix(args)
        segs = ""
        if args[7] is not None:
            starts = args[7] == torch.arange(m, device="cuda")
            segs = f", {int((starts & args[6]).sum())} segments with rows in the mask"
        say(
            f"phase 4 prefix commits == plain on a round of the t=0.3 fit, M={m} {call} "
            f"({args[0]}{segs})" + _prefix_timing_text(t)
        )
    timing["fit"] = timing["M=8192 pass 1"]  # the kernels line's record
    election, writes = _election_fit(samples), {}
    for m in (8192, 2048):
        args = _to_card(samples[("writes", m)])
        _writes_check(args, f"phase 4 pool and tile writes, round of the fit M={m}")
        t = writes[f"M={m}"] = _time_writes(args)
        say(
            f"phase 4 pool and tile writes == plain on a round of the t=0.3 fit, M={m} (tables "
            f"zeroed)" + _timing_text(t) + f" (every row charged as int32 sums "
            f"{t['bound_int32_ms']:.4g} ms, share {t['bound_int32_ms'] / t['ms']:.3f}); index_add_ "
            f"of the adders' rows {t['library_ms']:.4f} ms; over {t['copies']} copies"
        )
        del args
        torch.cuda.empty_cache()
    election["fit"], writes["fit"] = election["M=8192"], writes["M=8192"]
    # Bit-equal, else the phase failed
    return {
        "max_abs_err": 0.0, "timing": timing,
        "election": {"max_abs_err": 0.0, "timing": election},
        "writes": {"max_abs_err": 0.0, "timing": writes},
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
    launches = dict.fromkeys(LAUNCH_KEYS, 0)
    pred = {}
    for batch, kernel in ((8192, "sorted"), (1000, "rows")):
        _reset_counts()
        t0 = time.perf_counter()
        pred[batch] = tree.predict_packed(queries, batch=batch)
        wall = time.perf_counter() - t0
        n_sorted, n_rows, n_plan = _counts()
        n_route, _n_twin, route_generic = _add_launches(launches)
        say(
            f"phase 5 predict {len(queries)} queries at batch {batch}: "
            f"{wall:.3f} s, {len(queries) / wall:.0f} queries/s, kernel "
            f"launches {n_sorted} sorted + {n_rows} per-row + {n_plan} plan + "
            f"{n_route} route"
        )
        if (min(n_sorted, n_plan), n_rows)[kernel == "rows"] <= 0:
            raise AssertionError(f"predict at batch {batch} never launched the {kernel} kernel")
        _check_route_launches(n_route, route_generic, f"predict at batch {batch}")
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
    n_route, _n_twin, route_generic = _add_launches(launches)
    plain.check("the refine")
    say(
        f"phase 5 refine (n_largest=1): {wall:.2f} s, {n_cl} -> {ncl} clusters, "
        f"{engine.host_syncs - syncs0} host syncs, kernel launches {n_sorted} "
        f"sorted + {n_rows} per-row + {n_plan} plan + {n_route} route, pool_dead_rows "
        f"{tree.pool_dead_rows}, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated"
    )
    if n_sorted <= 0 or n_plan <= 0:
        raise AssertionError("the refine never launched the sorted search or the plan kernel")
    _check_route_launches(n_route, route_generic, "the refine")
    _check_prefix_launches("the refine")
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


def phase_cli(fps: np.ndarray, fit_walls: dict, plain: "_PlainOnCuda", tmp: Path) -> tuple[dict, Path]:
    r"""Phase 6: the port's command line from ``.npy`` files to pickles, in
    the directory ``tmp``; returns the launches and run (a)'s directory."""
    from bblean_tpu_torch.cli import main as cli_main
    from bblean_tpu_torch.fingerprints import make_fake_fingerprints
    from bblean_tpu_torch.ops import tile_search as ts

    launches = dict.fromkeys(LAUNCH_KEYS, 0)
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
        n_route, n_twin, route_generic = _add_launches(launches)
        if min(n_sorted, n_rows, n_plan) <= 0 or ts.generic_launches:
            raise AssertionError(
                f"phase 6 {what}: kernel launches {n_sorted} sorted + {n_rows} "
                f"per-row + {n_plan} plan, {ts.generic_launches} generic"
            )
        _check_route_launches(n_route, route_generic, f"phase 6 {what}")
        _check_prefix_launches(f"phase 6 {what}")
        plain.check(f"the command line ({what})")
        got = _check_run_dir(out_dir, fps, thr, what)
        t = got["timings"]
        peak = got["config"]["device_memory"]["peak_bytes_in_use"]
        parts = ", ".join(f"{k} {v:.2f} s" for k, v in t.items() if k != "total")
        say(
            f"phase 6 {what}: {got['n_clusters']} clusters (resident fit of phase 4: "
            f"{PORT_COUNTS[thr]}); total {t['total']:.2f} s of {wall:.2f} s in "
            f"main(): {parts}; resident-input fit of phase 4 {fit_walls[thr]:.2f} s; "
            f"kernel launches {n_sorted} sorted + {n_rows} per-row + {n_plan} plan + "
            f"{n_route} route + {n_twin} twin (0 generic); peak {peak / 2**30:.2f} GiB "
            f"allocated; device "
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
    return launches, tmp / "out-a"


class _MergeSearchCheck:
    r"""While installed, holds sampled launches of both tile-search front
    ends, as the engine's step makes them, bit-equal to the plain version on
    the same inputs (the first three launches of each front end after
    ``arm()`` and every 25th after).  A launch is either the dispatched one
    of a program's warm-up or one inside a replayed graph
    (``engine/graphs.py``): a capture launches nothing, so the wrapper notes
    the search's inputs and outputs in the program instead, and before a
    sampled replay the tile tables (which the round updates in place) are
    copied, so that after it the plain version reads what the replay read.
    The wrapper's own launch is the main path's; the plain version runs
    beside it and launches no kernel."""

    def __init__(self, plain: "_PlainOnCuda") -> None:
        from bblean_tpu_torch.engine import batch as engine, graphs

        self.engine, self.graphs, self.plain = engine, graphs, plain.plain
        self.planned, self.rows = engine.tile_search_planned, engine.tile_search_rows
        self.armed = False
        self.seen = {"sorted": 0, "rows": 0}
        self.checked = {"sorted": 0, "rows": 0}
        self.work = {"sorted": [], "rows": []}
        self.replayed = 0  # checked launches that ran inside a replay
        self._due_notes: list = []

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

    def _hold_call(self, kind, got, args, tiles):
        r"""``args``: (srows, spops, skey, order, pending) sorted, (row_pk,
        row_pop, row_group, pending) per-row; ``tiles``: (t_pk, t_pops,
        t_slot) as the launch read them."""
        if kind == "sorted":
            # Undo the plan's sort: the plain version takes rows in place
            srows, spops, skey, order, pending = args
            row_pk, row_pop = torch.empty_like(srows), torch.empty_like(spops)
            row_group = torch.empty_like(skey)
            row_pk[order], row_pop[order], row_group[order] = srows, spops, skey
            args = (row_pk, row_pop, row_group, pending)
        self._hold(kind, got, *args[:3], *tiles, args[3])

    def _call(self, kind, got, args, tiles):
        capture = self.graphs.capturing
        if capture is not None:
            refs = tuple(weakref.ref(t) for t in tiles)  # the program must not pin its tables
            capture.notes.setdefault(self, []).append((kind, got, args, refs))
        elif self._due(kind):
            self._hold_call(kind, got, args, tiles)
        return got

    def _planned(self, srows, spops, skey, order, t_pk, t_pops, t_slot, pending, items):
        got = self.planned(srows, spops, skey, order, t_pk, t_pops, t_slot, pending, items)
        return self._call("sorted", got, (srows, spops, skey, order, pending), (t_pk, t_pops, t_slot))

    def _rows(self, row_pk, row_pop, row_group, t_pk, t_pops, t_slot, pending):
        got = self.rows(row_pk, row_pop, row_group, t_pk, t_pops, t_slot, pending)
        return self._call("rows", got, (row_pk, row_pop, row_group, pending), (t_pk, t_pops, t_slot))

    def _observe(self, prog, stage: str) -> None:
        r"""A ``graphs`` observer: copies the tile tables before a sampled
        replay, holds the replay's launches after it (the noted inputs that
        are not tables are buffers the replay does not write, or its own
        temporaries, which hold this replay's values until the next)."""
        notes = prog.notes.get(self, ())
        if stage == "before":
            self._due_notes = [
                (kind, got, args, tuple(r().clone() for r in refs))
                for kind, got, args, refs in notes if self._due(kind)
            ]
            return
        for kind, got, args, tiles in self._due_notes:
            self._hold_call(kind, got, args, tiles)
            self.replayed += 1
        self._due_notes = []

    def __enter__(self):
        self.engine.tile_search_planned = self._planned
        self.engine.tile_search_rows = self._rows
        self.graphs.observers.append(self._observe)
        return self

    def __exit__(self, *exc) -> None:
        self.engine.tile_search_planned = self.planned
        self.engine.tile_search_rows = self.rows
        self.graphs.observers.remove(self._observe)


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
    fit_route = _kernel_counts()
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
    merge_route = tuple(b - a for a, b in zip(fit_route, _kernel_counts()))
    if ts.generic_launches or _route_counts()[2]:
        raise AssertionError(
            f"the sharded run took the generic path {ts.generic_launches} times "
            f"(tile search) and {_route_counts()[2]} times (route)"
        )
    _check_tma_path("the sharded run")
    return forest, {
        "fit_s": t1 - t0, "merge_s": t2 - t1, "n_clusters": ncl,
        "fit_launches": fit_counts, "merge_launches": merge_counts,
        "fit_route": fit_route, "merge_route": merge_route,
        "syncs": engine.host_syncs - syncs0, "fit_peak": fit_peak,
        "peak": torch.cuda.max_memory_allocated(),
    }


def _launch_text(counts) -> str:
    text = f"{counts[0]} sorted + {counts[1]} per-row + {counts[2]} plan"
    return text + "".join(
        f" + {c} {k}" for k, c in zip(LAUNCH_KEYS[3:], counts[3:])
    )


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

    launches = dict.fromkeys(LAUNCH_KEYS, 0)

    def add(counts) -> None:
        for k, c in zip(LAUNCH_KEYS, counts):
            launches[k] += c

    dev_fps = torch.from_numpy(fps).to("cuda:0")

    # (a) one shard at the bench's settings
    forest, r = _sharded_run(
        dev_fps, get_mesh(devices=["cuda:0"]), 0.3,
        initial_capacity=1 << 19, ls_capacity=1 << 18,
    )
    add(r["fit_launches"] + r["fit_route"])
    add(r["merge_launches"] + r["merge_route"])
    plain.check("the one-shard fit")
    wall = r["fit_s"] + r["merge_s"]
    say(
        f"phase 8 a: 1 shard, t=0.3: fit + merge {wall:.2f} s ({N_FPS / wall:.0f} fps/s; "
        f"merge {r['merge_s']:.3f} s), {r['n_clusters']} clusters (BatchTree: "
        f"{PORT_COUNTS[0.3]}), {r['syncs']} host syncs, kernel launches "
        f"{_launch_text(r['fit_launches'] + r['fit_route'])} (0 generic), {forest.growths} table growths, "
        f"peak {r['peak'] / 2**30:.2f} GiB allocated"
    )
    if min(r["fit_launches"]) <= 0 or r["fit_route"][2] <= 0:
        raise AssertionError("the one-shard fit did not launch every kernel")
    _check_route_launches(r["fit_route"][0], 0, "phase 8 a: the one-shard fit")
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
            with _MergeSearchCheck(plain) as check, _RouteWork(plain) as work:
                forest, r = _sharded_run(dev_fps, mesh8, thr, check, initial_capacity=cap)
            add(r["fit_launches"] + r["fit_route"])
            add(r["merge_launches"] + r["merge_route"])
            plain.check("the eight-shard fit and merge")
            wall = r["fit_s"] + r["merge_s"]
            say(
                f"phase 8 b: 8 shards on cuda:0, t={thr}, run {run}: fit {r['fit_s']:.2f} s, "
                f"merge {r['merge_s']:.2f} s ({r['merge_s'] / wall:.1%} of {wall:.2f} s; "
                f"{N_FPS / wall:.0f} fps/s), {r['n_clusters']} clusters, {r['syncs']} host "
                f"syncs, kernel launches: fit {_launch_text(r['fit_launches'] + r['fit_route'])}, "
                f"merge {_launch_text(r['merge_launches'] + r['merge_route'])} (0 generic), "
                f"{forest.growths} table "
                f"growths, capacities {forest.capacity} slots / {forest.g_capacity} groups "
                f"/ {forest.ls_capacity} pool rows, peak {r['fit_peak'] / 2**30:.2f} GiB "
                f"in the fit, {r['peak'] / 2**30:.2f} GiB in all (before graphed rounds: "
                f"{PEAK_BEFORE_GIB['8 shards']:.2f} GiB at t = 0.3)"
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
            if min(r["fit_launches"]) <= 0 or r["fit_route"][2] <= 0:
                raise AssertionError("the eight-shard fit did not launch every kernel")
            _check_route_launches(r["fit_route"][0], 0, "phase 8 b: the eight-shard fit")
            _check_route_launches(r["merge_route"][1], 0, "phase 8 b: the merge's twin")
            if work.checked["twin"] <= 0:
                raise AssertionError("phase 8 d: no twin launch of the merge was held to the plain version")
            rows_in = sum(
                s["rows"] for st in forest.merge_stats for s in st["receivers"].values()
            )
            if rows_in and min(
                r["merge_launches"][0], r["merge_launches"][2], r["merge_route"][0],
                r["merge_route"][2],
            ) <= 0:
                raise AssertionError(
                    "the merge inserted rows and launched no sorted search, route or prefix commit"
                )
            if rows_in and min(check.checked.values()) <= 0:
                raise AssertionError(f"phase 8 d: checked {check.checked} launches in the merge")
            say(
                f"phase 8 d: t={thr} run {run}: inside the merge {check.checked['sorted']} "
                f"sorted and {check.checked['rows']} per-row launches == plain on the "
                f"merge's inputs, {check.replayed} of them inside replayed graphs "
                f"(pending rows, tiles, M of the first three: sorted "
                f"{check.work['sorted'][:3]}, per-row {check.work['rows'][:3]}); "
                f"fit and merge: {work.text('route')}; merge: {work.text('twin')}"
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
        counts = _counts() + _kernel_counts()
        add(counts)
        if min(_counts()) <= 0 or counts[5] <= 0 or ts.generic_launches:
            raise AssertionError(
                f"phase 8 e: kernel launches {_launch_text(counts)}, "
                f"{ts.generic_launches} generic"
            )
        _check_route_launches(counts[3], _route_counts()[2], "phase 8 e")
        plain.check("the command line (--engine sharded)")
        got = _check_run_dir(out_dir, fps, 0.3, "e: --engine sharded, one file, t=0.3", 8)
        cfg, t = got["config"], got["timings"]
        parts = ", ".join(f"{k} {v:.2f} s" for k, v in t.items() if k != "total")
        say(
            f"phase 8 e: {got['n_clusters']} clusters (one shard of a: {count_a}); "
            f"{cfg['n_devices']} device(s), {cfg['device_table_bytes_per_device'] / 2**30:.2f} "
            f"GiB of tables per shard; total {t['total']:.2f} s of {wall:.2f} s in main(): "
            f"{parts}; kernel launches {_launch_text(counts)} (0 generic)"
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
    launches = dict.fromkeys(LAUNCH_KEYS, 0)
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
        n_route, _n_twin, route_generic = _add_launches(launches)
        if n_sorted <= 0 or n_plan <= 0 or ts.generic_launches:
            raise AssertionError(
                f"phase 9 b t={thr}: launches {n_sorted} sorted + {n_plan} plan, "
                f"{ts.generic_launches} generic"
            )
        _check_route_launches(n_route, route_generic, f"phase 9 b t={thr}")
        _check_prefix_launches(f"phase 9 b t={thr}")
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
        if sum(_counts()) + sum(_route_counts()) != 0:
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


# Phase 10: the clusters of the run directory that summary and the
# embeddings analyse; the rows per cluster of the cut that the t-SNE embeds
# on the card (the top 20 clusters of the 1M t = 0.3 run hold 193,964 rows,
# and the exact t-SNE's (N, N) float32 matrices would be 140 GiB each), and
# of the cut on which it is held to the CPU's
TOP = 20
TSNE_PER_CLUSTER = 1000
TSNE_CHECK_PER_CLUSTER = 100


def _cli_exit(argv) -> tuple[int, str, str]:
    r"""``cli.main(argv)`` in this process: its exit code, standard output
    and standard error."""
    import contextlib
    import io

    from bblean_tpu_torch.cli import main as cli_main

    out, err = io.StringIO(), io.StringIO()
    code = 0
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            cli_main(argv)
        except SystemExit as exc:
            code = exc.code if isinstance(exc.code, int) else 1
    return code, out.getvalue(), err.getvalue()


def _has(module: str) -> bool:
    import importlib.util

    return importlib.util.find_spec(module) is not None


def phase_analysis(run_dir: Path) -> None:
    r"""Phase 10: ``summary``, the PCA and t-SNE embeddings, and the
    commands whose optional packages the card's machine may lack, on the
    run directory of phase 6 (a)."""
    import pickle

    from bblean_tpu_torch import plotting
    from bblean_tpu_torch.analysis import cluster_analysis

    t_phase = time.perf_counter()
    csv = run_dir / "metrics.csv"
    t0 = time.perf_counter()
    code, out, err = _cli_exit([
        "summary", str(run_dir), "--top", str(TOP), "--chi", "--dbi", "--dunn",
        "--dump-metrics", str(csv),
    ])
    wall = time.perf_counter() - t0
    if code != 0:
        raise AssertionError(f"phase 10 summary exited {code}: {err}")
    want = [f"Total fingerprints: {N_FPS:,}", f"Total clusters: {PORT_COUNTS[0.3]:,}"]
    for line in want + ["CHI (higher better)", "DBI (lower better)", "Dunn (higher better)"]:
        if line not in out:
            raise AssertionError(f"phase 10 summary did not print {line!r}:\n{out}")
    rows = csv.read_text().splitlines()
    if rows[0] != "labels,sizes,isim" or len(rows) != TOP + 1:
        raise AssertionError(f"phase 10 summary's metrics file is {rows[:2]}... ({len(rows)} lines)")
    text = [ln for ln in out.splitlines() if ln.startswith(("Total", "Singletons", "Cluster sizes", "CHI", "DBI", "Dunn"))]
    say(f"phase 10 summary --top {TOP} --chi --dbi --dunn --dump-metrics: {wall:.2f} s in main(); " + "; ".join(text))

    with open(run_dir / "clusters.pkl", "rb") as f:
        clusters = pickle.load(f)
    fps_file = sorted((run_dir / "input-fps").glob("*.npy"))[0]
    t0 = time.perf_counter()
    analysis = cluster_analysis(clusters, fps=fps_file, top=TOP)
    n_rows = int(sum(analysis.sizes))
    say(
        f"phase 10 cluster_analysis of the top {TOP} clusters: {n_rows} rows (sizes "
        f"{analysis.sizes[0]} .. {analysis.sizes[-1]}) in {time.perf_counter() - t0:.2f} s"
    )
    t0 = time.perf_counter()
    pca = plotting.pca_embedding(analysis)
    pca_wall = time.perf_counter() - t0
    if pca.shape != (n_rows, 2) or not np.isfinite(pca).all():
        raise AssertionError(f"phase 10: the PCA embedding is {pca.shape}, or not finite")
    say(
        f"phase 10 PCA embedding of {n_rows} rows x {N_FEATURES} bits (host, the port's copy "
        f"of scikit-learn's randomized solver): {pca_wall:.2f} s, finite; the exact t-SNE "
        f"of as many rows would hold (N, N) float32 matrices of {n_rows**2 * 4 / 2**30:.1f} GiB"
    )
    cut = cluster_analysis([c[:TSNE_PER_CLUSTER] for c in clusters[:TOP]], fps=fps_file, top=TOP)
    n_cut = int(sum(cut.sizes))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    emb, tsne_wall = _timed(lambda: plotting.tsne_embedding(cut, device="cuda"))
    peak = torch.cuda.max_memory_allocated() / 2**30
    if emb.shape != (n_cut, 2) or not np.isfinite(emb).all():
        raise AssertionError(f"phase 10: the t-SNE embedding is {emb.shape}, or not finite")
    say(
        f"phase 10 t-SNE embedding of {n_cut} rows (the first {TSNE_PER_CLUSTER} of each top "
        f"cluster; PCA to 50 on the host, 750 iterations on the card): {tsne_wall:.2f} s, peak "
        f"{peak:.2f} GiB allocated on the card; finite, spread {emb.std(0)[0]:.3f} x "
        f"{emb.std(0)[1]:.3f}"
    )
    cut = [c[:TSNE_CHECK_PER_CLUSTER] for c in clusters[:TOP]]
    small = cluster_analysis(cut, fps=fps_file, top=TOP)
    a = plotting.tsne_embedding(small, n_iter=5, device="cuda")
    b = plotting.tsne_embedding(small, n_iter=5, device="cpu")
    rel = float(np.abs(a - b).max() / np.abs(b).max())
    say(
        f"phase 10 t-SNE CPU against CUDA ({len(a)} rows: the first "
        f"{TSNE_CHECK_PER_CLUSTER} of each top cluster), 5 iterations: largest difference "
        f"over the embedding's scale {rel:.2e} (held to 1e-3)"
    )
    if rel > 1e-3:
        raise AssertionError(f"phase 10: t-SNE after 5 iterations is {rel} of its scale off the CPU's")

    code, out, err = _cli_exit(["plot-tsne", str(run_dir), "--top", str(TOP)])
    if _has("matplotlib"):
        if code != 0 or not (run_dir / "tsne.png").is_file():
            raise AssertionError(f"phase 10 plot-tsne exited {code}: {err}")
        say("phase 10 plot-tsne: matplotlib is installed; wrote tsne.png")
    else:
        if code != 1 or "matplotlib" not in err:
            raise AssertionError(f"phase 10 plot-tsne without matplotlib exited {code}: {err}")
        say(f"phase 10 plot-tsne without matplotlib: exit 1, {err.strip()!r}")
    smi = run_dir / "mols.smi"
    smi.write_text("CCO\nCCC\n")
    code, out, err = _cli_exit(["fps-from-smiles", str(smi), "-o", str(run_dir / "smi-out")])
    if _has("rdkit"):
        if code != 0 or not (run_dir / "smi-out" / "fps.npy").is_file():
            raise AssertionError(f"phase 10 fps-from-smiles exited {code}: {err}")
        say("phase 10 fps-from-smiles: RDKit is installed; wrote fps.npy")
    else:
        if code != 1 or "RDKit" not in err:
            raise AssertionError(f"phase 10 fps-from-smiles without RDKit exited {code}: {err}")
        say(f"phase 10 fps-from-smiles without RDKit: exit 1, {err.strip()!r}")
    from importlib import metadata

    code, out, err = _cli_exit(["--version"])
    try:
        version = metadata.version("bblean-tpu")
    except metadata.PackageNotFoundError:
        if code != 1 or "not installed" not in err:
            raise AssertionError(f"phase 10 --version exited {code}: {out} {err}")
        say(f"phase 10 --version (distribution not installed here): exit 1, {err.strip()!r}")
    else:
        if code != 0 or out.strip() != f"bb-torch, version {version}":
            raise AssertionError(f"phase 10 --version exited {code}: {out} {err}")
        say(f"phase 10 --version: {out.strip()!r}")
    say(f"phase 10 took {time.perf_counter() - t_phase:.1f} s")


# Runs an example as ``python -m`` runs it, then prints as its last line
# the tile-search kernels' launches in that process and its wall from the
# interpreter's first statement (imports included)
_EXAMPLE_WRAPPER = (
    "import time\n"
    "t0 = time.perf_counter()\n"
    "import runpy, sys\n"
    "from bblean_tpu_torch.ops import route, tile_search as ts\n"
    "name = sys.argv[1]\n"
    "sys.argv = [name, *sys.argv[2:]]\n"
    "runpy.run_module('bblean_tpu_torch.examples.' + name, run_name='__main__')\n"
    "print('launches', ts.launches, ts.row_launches, ts.plan_launches,\n"
    "      route.route_launches, route.best_sim_launches,\n"
    "      time.perf_counter() - t0)\n"
)


def _start_example(name: str, args: list[str], cwd: Path) -> subprocess.Popen:
    r"""Start the example ``name`` with ``args`` in ``cwd``, through the
    wrapper above."""
    cwd.mkdir()
    env = dict(os.environ)
    root = str(Path(__file__).resolve().parent)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (root, env.get("PYTHONPATH")) if p)
    return subprocess.Popen(
        [sys.executable, "-c", _EXAMPLE_WRAPPER, name, *args], cwd=cwd, env=env,
        text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
    )


def _finish_example(what: str, proc: subprocess.Popen) -> tuple[list[str], tuple[int, ...], float]:
    r"""The example's printed lines, its kernel launches and its wall."""
    try:
        out, err = proc.communicate(timeout=600)
    finally:
        proc.kill()
    if proc.returncode != 0:
        raise AssertionError(f"phase 11 {what} exited {proc.returncode}:\n{err[-4000:]}")
    *lines, last = out.splitlines()
    tag, *counts, wall = last.split()
    if tag != "launches":
        raise AssertionError(f"phase 11 {what}: the wrapper's line is missing ({last!r})")
    return lines, tuple(int(c) for c in counts), float(wall)


def _held_lines(what: str, got: list[str], want: list[str]) -> None:
    if got != want:
        raise AssertionError(f"phase 11 {what} printed {got}, the JAX script {want}")


def phase_examples() -> dict:
    r"""Phase 11: the four examples as subprocesses, on the card."""
    from bblean_tpu_torch import BatchTree
    from bblean_tpu_torch.fingerprints import make_fake_fingerprints

    t_phase = time.perf_counter()
    launches = dict.fromkeys(LAUNCH_KEYS, 0)
    with tempfile.TemporaryDirectory(prefix="bb-smoke-examples-") as tmp:
        tmp = Path(tmp)
        # The five runs at once: the host engines use one core each, and
        # the two multi_device runs share the card
        host = ("quickstart", "best_practices", "dataset_splitting")
        args = {name: [] for name in host}
        args["md8"] = ["multi_device", "--device", "cuda:0", "--shards", "8"]
        args["md"] = ["multi_device"]
        started = {}
        try:
            for key, argv in args.items():
                name, *rest = argv or [key]
                started[key] = _start_example(name, rest, tmp / key)
            for name in host:
                lines, counts, wall = _finish_example(name, started[name])
                _held_lines(name, lines, EXAMPLE_LINES[name])
                if sum(counts):
                    raise AssertionError(f"phase 11 {name}: a host example launched a device kernel")
                say(
                    f"phase 11 {name}: {wall:.2f} s (the five runs at once), "
                    f"every line equal to the JAX script's: {' | '.join(lines[-2:])}"
                )
            if not (tmp / "quickstart" / "assignments.csv").is_file():
                raise AssertionError("phase 11 quickstart wrote no assignments.csv")

            name = "multi_device --shards 8 on cuda:0"
            lines, counts, wall = _finish_example(name, started["md8"])
            if min(counts[0], counts[2], counts[3], counts[4]) <= 0:
                raise AssertionError(f"phase 11 {name}: launches {counts}")
            want = f"devices: 8 x {torch.cuda.get_device_name(0)}"
            if lines[0] != want:
                raise AssertionError(f"phase 11 {name}: {lines[0]!r}, not {want!r}")
            _held_lines(name, lines[1:], EXAMPLE_LINES["multi_device"])
            say(
                f"phase 11 {name}: {wall:.2f} s, every line but the device equal to the JAX "
                f"script's on 8 CPU devices: {' | '.join(lines[1:])}; kernel launches "
                f"{_launch_text(counts)}"
            )

            name = "multi_device (default mesh)"
            lines, counts, wall = _finish_example(name, started["md"])
            if min(counts[0], counts[2], counts[3]) <= 0:
                raise AssertionError(f"phase 11 {name}: launches {counts}")
            n_cards = torch.cuda.device_count()
            got = int(lines[1].split()[0])
            fps = make_fake_fingerprints(
                MULTI_DEVICE_FIT["rows"], n_features=N_FEATURES, seed=MULTI_DEVICE_FIT["seed"],
            )
            batch = MULTI_DEVICE_FIT["batch_size"]
            _reset_counts()
            t0 = time.perf_counter()
            tree = BatchTree(
                N_FEATURES, threshold=MULTI_DEVICE_FIT["threshold"], batch_size=batch,
                route_block=512, initial_capacity=2 * batch + 2, device="cuda",
            )
            tree.fit_packed(fps, range(len(fps)))
            ncl = tree.num_clusters
            tree_wall = time.perf_counter() - t0
            n_route, _n_twin, route_generic = _add_launches(launches)
            say(
                f"phase 11 {name}: {wall:.2f} s, {lines[0]!r}, {got} clusters; BatchTree on "
                f"the same rows and settings: {ncl} clusters in {tree_wall:.2f} s (kernel "
                f"launches {_launch_text(_counts() + (n_route,))}); the example's launches "
                f"{_launch_text(counts)}"
            )
            if lines[0] != f"devices: {n_cards} x {torch.cuda.get_device_name(0)}":
                raise AssertionError(f"phase 11 {name}: the mesh is not every visible card")
            if n_cards == 1 and got != ncl:
                raise AssertionError(f"phase 11 {name}: one shard gave {got} clusters, BatchTree {ncl}")
            if min(_counts()) <= 0:
                raise AssertionError("phase 11: BatchTree did not launch every kernel")
            _check_route_launches(n_route, route_generic, "phase 11: BatchTree")
            _check_prefix_launches("phase 11: BatchTree")
        finally:
            for proc in started.values():  # a failed check stops the runs still going
                proc.kill()
    say(f"phase 11 took {time.perf_counter() - t_phase:.1f} s")
    return launches


def _only_examples() -> None:
    r"""Phases 1 and 11 alone (no kernels line, no result line)."""
    phase_device()
    with _PlainOnCuda() as plain:
        say("phase 11 launches:", phase_examples())
        plain.check("phase 11")


def _kernel_record(name, source, replaces, launches, phase, library_ms=None) -> dict:
    r"""One kernel's entry of the JSON line: times, bound and share at the
    "fit" case, the shape of the fit's average launch.  ``library_ms``: the
    PyTorch call measured beside the kernel (``torch._int_mm`` on the
    product alone, which the port never calls), or None where there is
    none."""
    t = phase["timing"]["fit"]
    return {
        "name": name,
        "route": "cuda",
        "source": f"bblean_tpu_torch/csrc/{source}",
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": phase["max_abs_err"],
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "share": t["share"],
        "library_ms": library_ms,
        **{k: t[k] for k in ("bound_full_ms", "share_full") if k in t},
    }


def _only_kernels() -> None:
    r"""Phases 1, 2, 2b, 2c, 2d, 2e, 2f, 2g and 2h alone (no kernels line,
    no result line)."""
    phase_device()
    phase_kernel()
    phase_row_kernel()
    phase_plan()
    phase_route()
    phase_prefix_commit()
    phase_election()
    phase_writes()
    phase_refresh()


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


def _only_analysis() -> None:
    r"""Phase 1, the command line's run (a) of phase 6 and phase 10 alone
    (no kernels line, no result line)."""
    from bblean_tpu_torch.fingerprints import make_fake_fingerprints

    phase_device()
    fps = make_fake_fingerprints(N_FPS, N_FEATURES, seed=SEED)
    with tempfile.TemporaryDirectory(prefix="bb-smoke-") as tmp:
        tmp = Path(tmp)
        np.save(tmp / "fps.npy", fps)
        run_dir = tmp / "out-a"
        _reset_counts()
        code, out, err = _cli_exit([
            "run", str(tmp / "fps.npy"), "-o", str(run_dir), "-t", "0.3",
            "--engine", "batch", "--no-monitor-mem", "-V",
        ])
        n_clusters = json.loads((run_dir / "config.json").read_text())["n_clusters"] if code == 0 else None
        if code != 0 or n_clusters != PORT_COUNTS[0.3] or min(_counts()) <= 0:
            raise AssertionError(f"run (a) exited {code} with {n_clusters} clusters, launches {_counts()}: {err}")
        say(f"phase 6 a: {n_clusters} clusters, launches {_launch_text(_counts())}")
        phase_analysis(run_dir)


def main() -> None:
    # A termination unwinds like an error, so every started process is stopped
    import signal

    signal.signal(signal.SIGTERM, lambda signum, _frame: sys.exit(128 + signum))
    if sys.argv[1:] == ["--only", "kernels"]:
        return _only_kernels()
    if sys.argv[1:] == ["--only", "sharded"]:
        return _only_sharded()
    if sys.argv[1:] == ["--only", "bitbirch"]:
        return _only_bitbirch()
    if sys.argv[1:] == ["--only", "analysis"]:
        return _only_analysis()
    if sys.argv[1:] == ["--only", "examples"]:
        return _only_examples()
    if sys.argv[1:] == ["--only", "refresh"]:
        return _only_refresh()
    kind = phase_device()
    kern = phase_kernel()
    rows = phase_row_kernel()
    plan = phase_plan()
    routes = phase_route()
    prefix = phase_prefix_commit()
    phase_election()
    phase_writes()
    phase_refresh()
    phase_cpu_vs_cuda()
    full = phase_full_size()
    prefix_fit = phase_prefix_fit(full["prefix_samples"])
    refresh_fit = phase_refresh_fit()
    with _PlainOnCuda() as plain:
        examples = phase_examples()
        plain.check("phase 11")
    for k, c in examples.items():
        full["launches"][k] += c
    say(json.dumps({"kernels": [
        _kernel_record(
            "tile_search_sorted", "tile_search.cu", "bblean_tpu/ops/pallas_search2.py:61",
            full["launches"]["sorted"], kern, kern["library_ms"],
        ),
        _kernel_record(
            "tile_search_rows", "tile_search.cu", "bblean_tpu/ops/pallas_search.py:42",
            full["launches"]["rows"], rows,
        ),
        _kernel_record(
            "sorted_search_plan_items", "tile_search.cu",
            "bblean_tpu/ops/pallas_search2.py:245", full["launches"]["plan"], plan,
        ),
        _kernel_record(
            "route_argmax", "route.cu", "bblean_tpu/engine/batch.py:203",
            full["launches"]["route"], routes["route"],
            routes["route"]["timing"]["fit"]["library_ms"],
        ),
        _kernel_record(
            "best_group_sim", "route.cu", "bblean_tpu/parallel/sharded.py:117",
            full["launches"]["twin"], routes["twin"],
            routes["twin"]["timing"]["fit"]["library_ms"],
        ),
        _kernel_record(
            "prefix_commit", "prefix_commit.cu", "bblean_tpu/engine/batch.py:406",
            full["launches"]["prefix-commit"], prefix_fit,
            prefix_fit["timing"]["fit"]["library_ms"],
        ),
        _kernel_record(
            "leader_election", "leader_election.cu", "bblean_tpu/engine/batch.py:504",
            full["launches"]["leader-election"], prefix_fit["election"],
        ),
        _kernel_record(
            "commit_writes", "commit_writes.cu", "bblean_tpu/engine/batch.py:660",
            full["launches"]["commit-writes"], prefix_fit["writes"],
            prefix_fit["writes"]["timing"]["fit"]["library_ms"],
        ),
        _kernel_record(
            "refresh_touched", "refresh.cu", "bblean_tpu/engine/batch.py:891",
            refresh_fit["launches"], refresh_fit,
        ),
    ]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
