r"""North-star scale check of the port: 10M x 2048-bit fingerprints, one card.

The twin of ``benchmarks/scale_10m.py``: the same seed, arguments and
``BatchTree`` settings (tile 512, fanout 384, group capacity 2^15 below
t = 0.5 and 2^16 from it, cluster capacity 2^23 / 2^24, linear-sum pool
2^16), the main path ``BatchTree.fit_packed`` with both tile-search
kernels of ``csrc/tile_search.cu`` at 512-cell tiles and the route kernel
of ``csrc/route.cu`` over up to 43k groups, and the prefix-commit kernel
of ``csrc/prefix_commit.cu`` three times an insert round, the leader
election of ``csrc/leader_election.cu`` and the pool and tile writes of
``csrc/commit_writes.cu`` once a round.

Usage, from the repository root::

    python3 -m bblean_tpu_torch.benchmarks.scale_10m [n_millions] [threshold] [streamed]

(defaults 10 and 0.65).  The fingerprints are made once by
``make_fake_fingerprints`` and kept in ``.scratch/fps{n}m.npy``; making 10M
holds about 41 GB of unpacked bits on the host for a few minutes.  The input
is resident on the card as a tensor unless ``streamed`` is given; then it
stays a host array that ``fit_packed`` stages in chunks.  A warm-up tree
fits 65,536 rows and runs ``warm_programs`` (the kernels are built or
loaded, the caching allocator warmed), the timed tree runs
``warm_programs`` too, and then the fit is timed.

It prints the fit's wall and fps/s, the cluster count (beside the JAX
record's, as information), the groups, the linear-sum pool's rows, the
tile-search, route, prefix-commit, leader-election and writes kernels'
launches in the fit (it fails if the sorted front end, the plan kernel,
the route, the prefix commits, the election or the writes never ran, a
launch took
a generic path, or a route launch missed the TMA path), the
extraction's wall (``cluster_sizes`` + ``cluster_mols``; every molecule
must come out once), the card's peak allocated memory from the timed
tree's construction on, and the process's peak resident memory on the
host.  At 10M rows that peak is held to the budget below.
The last line is one JSON object with those numbers.  Without a CUDA device
it exits non-zero and prints no result.
"""

from __future__ import annotations

import itertools
import json
import resource
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

SEED = 12620509540149709235
ROOT = Path(__file__).resolve().parents[2]
# Cluster counts of the JAX engine at 10M rows (another backend's float32
# iSIM), printed beside the port's as information
JAX_COUNTS = {0.3: 3_977_532, 0.65: 9_783_327}
# The port's budget for the card's peak allocated memory at 10M rows, by
# (threshold, streamed): the first run's peak plus 15%.  That run, on an
# NVIDIA H100 80GB HBM3 at a 700.00 W power limit, peaked at 8.69 GiB
# (t = 0.3, resident), 13.26 GiB (t = 0.65, resident) and 11.34 GiB
# (t = 0.65, streamed)
PEAK_BUDGET_GIB = {(0.3, False): 10.00, (0.65, False): 15.25, (0.65, True): 13.05}


def main(argv: list[str] | None = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        raise SystemExit("scale_10m: torch.cuda.is_available() is False; no result")
    from bblean_tpu_torch import BatchTree
    from bblean_tpu_torch.fingerprints import make_fake_fingerprints
    from bblean_tpu_torch.ops import (
        commit_writes, leader_election, prefix_commit, route, tile_search,
    )

    n_m = int(argv[0]) if len(argv) > 0 else 10
    threshold = float(argv[1]) if len(argv) > 1 else 0.65
    streamed = "streamed" in argv[2:]
    n = n_m * 1_000_000
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip(), flush=True)

    t0 = time.perf_counter()
    cache = ROOT / ".scratch" / f"fps{n_m}m.npy"
    if cache.exists():
        fps = np.load(cache, mmap_mode="r")
        print(f"gen: cached ({cache}) {fps.nbytes / 1e9:.2f} GB", flush=True)
    else:
        fps = make_fake_fingerprints(n, seed=SEED)
        gen_s = time.perf_counter() - t0
        cache.parent.mkdir(exist_ok=True)
        np.save(cache, fps)
        print(f"gen: {gen_s:.1f} s, saved in {time.perf_counter() - t0 - gen_s:.1f} s, {fps.nbytes / 1e9:.2f} GB", flush=True)

    kw = dict(
        threshold=threshold,
        batch_size=8192,
        fanout=384,
        tile=512,
        g_capacity=1 << 16 if threshold >= 0.5 else 1 << 15,
        initial_capacity=1 << 24 if threshold >= 0.5 else 1 << 23,
        ls_capacity=1 << 16,
        device="cuda",
    )
    t0 = time.perf_counter()
    if streamed:
        fit_input = np.asarray(fps)
        print("input: host array, staged by fit_packed in chunks", flush=True)
    else:
        fit_input = torch.from_numpy(np.array(fps)).to("cuda")
        torch.cuda.synchronize()
        print(f"input: resident on the card, staged in {time.perf_counter() - t0:.2f} s", flush=True)

    # Warm-up: the kernels built or loaded, the allocator warmed at the
    # timed run's table and window shapes
    warm = BatchTree(2048, **kw)
    window = warm.scan_batches * warm.batch_size
    with warnings.catch_warnings():
        # A read-only mapped file gives a tensor that is only read
        warnings.filterwarnings("ignore", message="The given NumPy array is not writable")
        if streamed:
            n_w = -(-n // window)
            chunk_rows = (1 if n_w <= 1 else warm.stage_windows) * window
            warm_rows = torch.from_numpy(np.ascontiguousarray(fps[:chunk_rows])).to("cuda")
        else:
            warm_rows = fit_input
    warm.fit_packed(warm_rows[: 1 << 16], range(1 << 16))
    warm.warm_programs(warm_rows)
    torch.cuda.synchronize()
    del warm
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    tree = BatchTree(2048, **kw)
    tree.warm_programs(warm_rows)
    del warm_rows
    torch.cuda.synchronize()
    tile_search.launches = tile_search.row_launches = 0
    tile_search.plan_launches = tile_search.generic_launches = 0
    route.route_launches = route.generic_launches = route.wgmma_launches = 0
    prefix_commit.launches = leader_election.launches = commit_writes.launches = 0
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="The given NumPy array is not writable")
        tree.fit_packed(fit_input, range(n))
    num = tree.num_clusters
    fit_s = time.perf_counter() - t0
    launches = {
        "sorted": tile_search.launches, "rows": tile_search.row_launches,
        "plan": tile_search.plan_launches, "generic": tile_search.generic_launches,
        "route": route.route_launches, "route_generic": route.generic_launches,
        "route_wgmma": route.wgmma_launches, "prefix_commit": prefix_commit.launches,
        "leader_election": leader_election.launches, "commit_writes": commit_writes.launches,
    }
    groups, ls_rows = tree.num_groups, int(tree.state.num_ls)
    print(
        f"fit: {fit_s:.2f} s = {n / fit_s:,.0f} fps/s  clusters={num:,} "
        f"groups={groups:,}  ls_pool={ls_rows:,}  kernel launches {launches}",
        flush=True,
    )
    if (
        min(
            launches[k] for k in (
                "sorted", "plan", "route", "prefix_commit", "leader_election", "commit_writes",
            )
        ) <= 0
        or launches["generic"] or launches["route_generic"]
        or launches["route_wgmma"] != launches["route"]
    ):
        raise AssertionError(f"the fit did not run on the kernels: {launches}")
    jax_count = JAX_COUNTS.get(threshold) if n_m == 10 else None
    if jax_count is not None:
        print(
            f"JAX record at 10M, t={threshold}: {jax_count:,} clusters; the port's "
            f"differs by {(num - jax_count) / jax_count:+.3%}",
            flush=True,
        )
    # The fit no longer needs the input; extraction runs without it
    del fit_input
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    sizes = tree.cluster_sizes()
    mols = tree.cluster_mols()
    extract_s = time.perf_counter() - t0
    seen = np.bincount(
        np.fromiter(itertools.chain.from_iterable(mols), np.int64, count=int(sizes.sum())),
        minlength=n,
    )
    if sizes.sum() != n or len(seen) != n or not (seen == 1).all():
        raise AssertionError("extraction did not give every molecule once")
    print(f"extraction: {extract_s:.2f} s (every molecule once)", flush=True)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    reserved_gib = torch.cuda.max_memory_reserved() / 2**30
    host_gib = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20  # kB on Linux
    print(
        f"peak allocated: {peak_gib:.2f} GiB (reserved {reserved_gib:.2f} GiB); "
        f"host peak RSS {host_gib:.2f} GiB",
        flush=True,
    )
    budget = PEAK_BUDGET_GIB.get((threshold, streamed)) if n_m == 10 else None
    result = {
        "n": n, "threshold": threshold, "streamed": streamed, "fit_s": fit_s,
        "fps_per_s": n / fit_s, "clusters": num, "groups": groups,
        "ls_pool_rows": ls_rows, "launches": launches, "extract_s": extract_s,
        "peak_allocated_gib": peak_gib, "peak_reserved_gib": reserved_gib,
        "host_peak_rss_gib": host_gib,
        "jax_count": jax_count, "peak_budget_gib": budget,
    }
    print(json.dumps(result), flush=True)
    if budget is not None and peak_gib > budget:
        raise SystemExit(
            f"memory regression: peak {peak_gib:.2f} GiB exceeds the {budget} GiB "
            f"budget of the 10M t={threshold} {'streamed' if streamed else 'resident'} run"
        )


if __name__ == "__main__":
    main()
