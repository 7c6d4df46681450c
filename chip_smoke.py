r"""Smoke run of the PyTorch port on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``.  It needs one CUDA
device and ``nvcc``, imports no JAX, and prints one line per phase as soon
as the phase ends:

1. device: the card's name and power limit (then the line
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
   prints); build the tile-search kernels;
2. the sorted tile-search kernel against its plain PyTorch version on the
   card, at the batch engine's shapes (sims bit-equal, slots equal where a
   candidate exists), and both versions' times;
2b. the per-row tile-search kernel against the same plain version, at the
   narrow rounds' and predict's shapes, and both versions' times;
3. the port on the CPU (plain search) and on the card (kernels) give the
   same labels for 20,000 fingerprints after the fit, a shuffled
   recluster and a refine, and the same predicted slots and sims for
   2,000 queries at an aligned and an unaligned batch size;
4. the fit path at full size: 1M x 2048-bit fingerprints at t = 0.3 and
   t = 0.65 through ``BatchTree.fit_packed``, every molecule assigned once,
   sampled clusters meeting the diameter criterion in float64, and the
   cluster counts exactly the port's own (397,552 and 983,222; their
   distance to the JAX engine's record is printed as information);
5. on the t = 0.3 tree of phase 4: ``predict_packed`` of 131,072 queries
   through the sorted kernel (batch 8192) and the per-row kernel (batch
   1000), identical and equal to a float64 Tanimoto against the packed
   centroids; both kernels timed on the tree's tables at batches of 1000,
   1024 and 8192; then ``refine_inplace`` of the largest cluster, with every
   molecule assigned once, sampled linear sums equal to their members'
   bits and sampled clusters meeting the diameter criterion.

Each main-path run (each fit, each predict, the refine) counts the kernels'
launches from zero and must launch the kernels it runs; the plain search
must never see CUDA tensors.  The line before the last is a JSON object with
each kernel's launches, error and times; the last line is
``{"ok": true, "device": {...}}``.  Any failed phase raises and the script
exits non-zero without a result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

N_FPS = 1_000_000
N_FEATURES = 2048
SEED = 12620509540149709235
# Cluster counts of the JAX engine for this input (the last parsed bench),
# printed as information; the port's own deterministic counts are held
# exactly
JAX_COUNTS = {0.3: 395_183, 0.65: 983_380}
PORT_COUNTS = {0.3: 397_552, 0.65: 983_222}
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


def _search_case(gen, m, g, fc, f8, concentration, empty=False):
    dev = "cuda"
    t_pk = torch.randint(0, 256, (g, fc, f8), generator=gen, device=dev, dtype=torch.uint8)
    occ = torch.rand((g, fc), generator=gen, device=dev) < 0.7
    if empty:
        occ[:] = False
    occ[g - 1] = False  # the engine's guard tile holds no live cell
    t_slot = torch.where(
        occ, torch.randint(0, 1 << 20, (g, fc), generator=gen, device=dev, dtype=torch.int32), -1
    )
    t_pk[~occ] = 0
    from bblean_tpu_torch.ops.tile_search import _popcount_u8

    t_pops = _popcount_u8(t_pk).sum(-1, dtype=torch.int32)
    row_pk = torch.randint(0, 256, (m, f8), generator=gen, device=dev, dtype=torch.uint8)
    row_pop = _popcount_u8(row_pk).sum(-1, dtype=torch.int32)
    if concentration == "one":
        row_group = torch.zeros(m, dtype=torch.int32, device=dev)
    elif concentration == "few":
        row_group = torch.randint(0, 3, (m,), generator=gen, device=dev, dtype=torch.int32)
    else:  # spread
        row_group = torch.randint(0, g - 1, (m,), generator=gen, device=dev, dtype=torch.int32)
    pending = torch.rand(m, generator=gen, device=dev) < 0.8
    # Pending rows with groups outside the table: read as JAX's gather reads
    # them (wrapped once if negative, then clamped), by kernels and plain
    oob = torch.tensor([g + 7, -1, -g - 5, 1 << 30], dtype=torch.int32, device=dev)[:m]
    row_group[: len(oob)] = oob
    pending[: len(oob)] = True
    return row_pk, row_pop, row_group, t_pk, t_pops, t_slot, pending


def _median_ms(fn, reps=15) -> float:
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


def phase_kernel() -> dict:
    from bblean_tpu_torch.ops import tile_search as ts

    gen = torch.Generator(device="cuda").manual_seed(7)
    g = 4096
    cases = [
        (m, fc, 256, conc, False)
        for m in (8192, 2048)
        for fc in (256, 512)
        for conc in ("one", "few", "spread")
    ] + [(8192, 256, 256, "spread", True), (2048, 64, 33, "few", False)]
    max_err = 0.0
    timing = {}
    for m, fc, f8, conc, empty in cases:
        row_pk, row_pop, row_group, t_pk, t_pops, t_slot, pending = _search_case(
            gen, m, g, fc, f8, conc, empty
        )
        order, skey = ts.sorted_search_plan(torch.where(pending, row_group, g - 1))
        srows, spops = row_pk[order], row_pop[order]

        def kernel():
            return ts.tile_search_planned(
                srows, spops, skey, order, t_pk, t_pops, t_slot, pending
            )

        def plain():
            return ts.search_tiles_plain(
                row_pk, row_pop, row_group, t_pk, t_pops, t_slot, pending
            )

        what = f"M={m} Fc={fc} F8={f8} {conc}{' empty' if empty else ''}"
        got = kernel()
        max_err = max(max_err, _check_equal(got, plain(), what))
        if empty and bool((got[0] > -1.5).any()):
            raise AssertionError("empty tiles produced a candidate")
        line = f"phase 2 kernel == plain: {what}"
        if m == 8192 and fc == 256 and f8 == 256 and not empty:
            kms, pms = _median_ms(kernel), _median_ms(plain)
            timing[conc] = (kms, pms)
            line += f" | kernel {kms:.4f} ms, plain {pms:.4f} ms (median of 15)"
        say(line)
    return {"max_abs_err": max_err, "timing": timing}


def phase_row_kernel() -> dict:
    r"""The per-row kernel against the plain version: the narrow rounds'
    width (2048), an unaligned width (1000), the fit's batch (8192);
    256- and 512-cell tiles; 2048- and 264-bit rows; rows on one group, on
    three, and on all 4,095; all-empty tiles; a pending mask, the masked
    rows carrying out-of-range groups."""
    from bblean_tpu_torch.ops import tile_search as ts

    gen = torch.Generator(device="cuda").manual_seed(11)
    g = 4096
    cases = [
        (m, fc, f8, conc, False)
        for m in (8192, 2048, 1000)
        for fc in (256, 512)
        for f8 in (256, 33)
        for conc in ("one", "few", "spread")
    ] + [(2048, 256, 256, "spread", True), (1000, 512, 33, "few", True)]
    max_err = 0.0
    timing = {}
    for m, fc, f8, conc, empty in cases:
        row_pk, row_pop, row_group, t_pk, t_pops, t_slot, pending = _search_case(
            gen, m, g, fc, f8, conc, empty
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

        what = f"M={m} Fc={fc} F8={f8} {conc}{' empty' if empty else ''}"
        got = kernel()
        max_err = max(max_err, _check_equal(got, plain(), f"per-row {what}"))
        if empty and bool((got[0] > -1.5).any()):
            raise AssertionError("empty tiles produced a candidate")
        line = f"phase 2b per-row kernel == plain: {what}"
        if m == 2048 and fc == 256 and f8 == 256 and conc != "one" and not empty:
            kms, pms = _median_ms(kernel), _median_ms(plain)
            timing[conc] = (kms, pms)
            line += f" | kernel {kms:.4f} ms, plain {pms:.4f} ms (median of 15)"
        say(line)
    return {"max_abs_err": max_err, "timing": timing}


def _reset_counts() -> None:
    from bblean_tpu_torch.ops import tile_search as ts

    ts.launches = 0
    ts.row_launches = 0


def _counts() -> tuple[int, int]:
    from bblean_tpu_torch.ops import tile_search as ts

    return ts.launches, ts.row_launches


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
    labels = tree.assignments()
    sizes = tree.cluster_sizes()
    if labels.shape != (N_FPS,) or (labels < 0).any():
        raise AssertionError("not every molecule was assigned")
    if int(sizes.sum()) != N_FPS:
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

    launches = {"sorted": 0, "rows": 0}
    kept = None
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
            wall = time.perf_counter() - t0
            n_sorted, n_rows = _counts()
            launches["sorted"] += n_sorted
            launches["rows"] += n_rows
            syncs = engine.host_syncs - syncs0
            rel = (ncl - JAX_COUNTS[thr]) / JAX_COUNTS[thr]
            say(
                f"phase 4 t={thr}: fit {wall:.2f} s, {N_FPS / wall:.0f} fps/s, "
                f"{ncl} clusters (port's count {PORT_COUNTS[thr]}; JAX record "
                f"{JAX_COUNTS[thr]}, rel diff {rel:+.5%}), {syncs} host syncs, "
                f"kernel launches {n_sorted} sorted + {n_rows} per-row, peak "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated"
            )
            if n_sorted <= 0:
                raise AssertionError("the fit never launched the sorted tile-search kernel")
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
        phase5 = phase_predict_refine(kept, fps, plain)
    return {
        "launches": {k: launches[k] + phase5[k] for k in launches},
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


def phase_predict_refine(tree, fps: np.ndarray, plain: _PlainOnCuda) -> dict:
    r"""Phase 5 on the t = 0.3 tree: predict through both kernels, then a
    refine of the largest cluster."""
    from bblean_tpu_torch.engine import batch as engine

    queries = fps[:131_072]
    launches = {"sorted": 0, "rows": 0}
    pred = {}
    for batch, kernel in ((8192, "sorted"), (1000, "rows")):
        _reset_counts()
        t0 = time.perf_counter()
        pred[batch] = tree.predict_packed(queries, batch=batch)
        wall = time.perf_counter() - t0
        n_sorted, n_rows = _counts()
        launches["sorted"] += n_sorted
        launches["rows"] += n_rows
        say(
            f"phase 5 predict {len(queries)} queries at batch {batch}: "
            f"{wall:.3f} s, {len(queries) / wall:.0f} queries/s, kernel "
            f"launches {n_sorted} sorted + {n_rows} per-row"
        )
        if (n_sorted, n_rows)[kernel == "rows"] <= 0:
            raise AssertionError(f"predict at batch {batch} never launched the {kernel} kernel")
        plain.check("predict")
    slots, sims = pred[8192]
    if not (np.array_equal(slots, pred[1000][0]) and np.array_equal(sims, pred[1000][1])):
        raise AssertionError("predict differs between the sorted and the per-row kernel")
    n_cl = tree.num_clusters
    if (slots < 0).any() or (slots >= n_cl).any():
        raise AssertionError("predict returned a slot outside the tree")
    cents = tree.packed_centroids()
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
    n_sorted, n_rows = _counts()
    launches["sorted"] += n_sorted
    launches["rows"] += n_rows
    plain.check("the refine")
    say(
        f"phase 5 refine (n_largest=1): {wall:.2f} s, {n_cl} -> {ncl} clusters, "
        f"{engine.host_syncs - syncs0} host syncs, kernel launches {n_sorted} "
        f"sorted + {n_rows} per-row, pool_dead_rows {tree.pool_dead_rows}, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated"
    )
    if n_sorted <= 0:
        raise AssertionError("the refine never launched the sorted tile-search kernel")
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
    return launches


def main() -> None:
    kind = phase_device()
    kern = phase_kernel()
    rows = phase_row_kernel()
    phase_cpu_vs_cuda()
    full = phase_full_size()
    kms, pms = kern["timing"]["few"]
    rkms, rpms = rows["timing"]["few"]
    say(json.dumps({"kernels": [
        {
            "name": "tile_search_sorted",
            "route": "cuda",
            "source": "bblean_tpu_torch/csrc/tile_search.cu",
            "replaces": "bblean_tpu/ops/pallas_search2.py:61",
            "launches": full["launches"]["sorted"],
            "max_abs_err": kern["max_abs_err"],
            "ms": kms,
            "plain_ms": pms,
        },
        {
            "name": "tile_search_rows",
            "route": "cuda",
            "source": "bblean_tpu_torch/csrc/tile_search.cu",
            "replaces": "bblean_tpu/ops/pallas_search.py:42",
            "launches": full["launches"]["rows"],
            "max_abs_err": rows["max_abs_err"],
            "ms": rkms,
            "plain_ms": rpms,
        },
    ]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
