r"""Smoke run of the PyTorch port on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``.  It needs one CUDA
device and ``nvcc``, imports no JAX, and prints one line per phase as soon
as the phase ends:

1. device: the card's name and power limit; build the tile-search kernel;
2. the kernel against its plain PyTorch version on the card, at the batch
   engine's shapes (sims bit-equal, slots equal where a candidate exists),
   and both versions' times;
3. the port on the CPU (plain search) and on the card (kernel) give the
   same labels for 20,000 fingerprints;
4. the fit path at full size: 1M x 2048-bit fingerprints at t = 0.3 and
   t = 0.65 through ``BatchTree.fit_packed``, every molecule assigned once,
   sampled clusters meeting the diameter criterion in float64, and the
   cluster counts within 1% of the JAX engine's record.

The line before the last is a JSON object with each kernel's launches,
error and times; the last line is ``{"ok": true, "device": {...}}``.  Any
failed phase raises and the script exits non-zero without a result.
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
# Cluster counts of the JAX engine for this input (the last parsed bench)
JAX_COUNTS = {0.3: 395_183, 0.65: 983_380}
FIT_SETTINGS = {
    0.3: dict(initial_capacity=1 << 19, ls_capacity=1 << 18),
    0.65: dict(initial_capacity=1 << 21, ls_capacity=1 << 18),
}


def say(*parts) -> None:
    print(*parts, flush=True)


def phase_device() -> dict:
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
        f"phase 1 device: {name} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | kernel build {_build.build_seconds['tile_search.cu']:.2f} s "
        f"(load {built:.2f} s)"
    )
    return {"kind": name, "smi": smi}


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

        k_sim, k_slot = kernel()
        p_sim, p_slot = plain()
        torch.cuda.synchronize()
        if not torch.equal(k_sim, p_sim):
            raise AssertionError(f"sims differ at M={m} Fc={fc} F8={f8} {conc}")
        cand = p_sim > -1.5
        if not torch.equal(k_slot[cand], p_slot[cand]):
            raise AssertionError(f"slots differ at M={m} Fc={fc} F8={f8} {conc}")
        if empty and bool(cand.any()):
            raise AssertionError("empty tiles produced a candidate")
        max_err = max(max_err, float((k_sim - p_sim).abs().max()))
        line = f"phase 2 kernel == plain: M={m} Fc={fc} F8={f8} {conc}{' empty' if empty else ''}"
        if m == 8192 and fc == 256 and f8 == 256 and not empty:
            kms, pms = _median_ms(kernel), _median_ms(plain)
            timing[conc] = (kms, pms)
            line += f" | kernel {kms:.4f} ms, plain {pms:.4f} ms (median of 15)"
        say(line)
    return {"max_abs_err": max_err, "timing": timing}


def phase_cpu_vs_cuda() -> None:
    from bblean_tpu.fingerprints import make_fake_fingerprints
    from bblean_tpu_torch import BatchTree

    fps = make_fake_fingerprints(20_000, N_FEATURES, seed=SEED)
    labels = {}
    for device in ("cpu", "cuda"):
        t0 = time.perf_counter()
        tree = BatchTree(N_FEATURES, threshold=0.3, batch_size=1024, device=device)
        tree.fit_packed(fps, range(len(fps)))
        labels[device] = tree.assignments()
        say(
            f"phase 3 {device}: 20k fps t=0.3 -> {tree.num_clusters} clusters "
            f"in {time.perf_counter() - t0:.2f} s"
        )
    if not np.array_equal(labels["cpu"], labels["cuda"]):
        n = int((labels["cpu"] != labels["cuda"]).sum())
        raise AssertionError(f"CPU and CUDA labels differ for {n} molecules")
    say("phase 3 CPU and CUDA labels identical")


def _check_fit(tree, fps: np.ndarray, threshold: float) -> None:
    from bblean_tpu._np_similarity import jt_isim_from_sum

    labels = tree.assignments()
    sizes = tree.cluster_sizes()
    if labels.shape != (N_FPS,) or (labels < 0).any():
        raise AssertionError("not every molecule was assigned")
    if int(sizes.sum()) != N_FPS:
        raise AssertionError(f"cluster sizes sum to {int(sizes.sum())}")
    if not np.array_equal(np.bincount(labels, minlength=len(sizes)), sizes):
        raise AssertionError("assignments disagree with cluster sizes")
    multi = np.flatnonzero(sizes >= 2)
    rng = np.random.default_rng(0)
    pick = rng.choice(multi, size=min(1000, len(multi)), replace=False)
    order = np.argsort(labels, kind="stable")
    bounds = np.searchsorted(labels[order], np.arange(len(sizes) + 1))
    worst = np.inf
    for c in pick:
        members = order[bounds[c] : bounds[c + 1]]
        ls = np.unpackbits(fps[members], axis=1).sum(0, dtype=np.uint64)
        worst = min(worst, jt_isim_from_sum(ls, len(members)))
    if worst < threshold - 1e-6:
        raise AssertionError(f"a sampled cluster has iSIM {worst} < {threshold}")
    say(
        f"phase 4 t={threshold}: all {N_FPS} molecules assigned once; "
        f"{len(pick)} sampled multi-member clusters meet the diameter "
        f"criterion (min float64 iSIM {worst:.6f})"
    )


def phase_full_size() -> dict:
    from bblean_tpu.fingerprints import make_fake_fingerprints
    from bblean_tpu_torch import BatchTree
    from bblean_tpu_torch.engine import batch as engine
    from bblean_tpu_torch.ops import tile_search as ts

    t0 = time.perf_counter()
    fps = make_fake_fingerprints(N_FPS, N_FEATURES, seed=SEED)
    dev_fps = torch.from_numpy(fps).to("cuda")
    torch.cuda.synchronize()
    say(f"phase 4 input: {N_FPS} x {N_FEATURES}-bit fps staged on the card in {time.perf_counter() - t0:.1f} s")

    plain_on_cuda = 0
    plain = ts.search_tiles_plain

    def counted_plain(row_pk, *args):
        nonlocal plain_on_cuda
        plain_on_cuda += row_pk.device.type == "cuda"
        return plain(row_pk, *args)

    ts.search_tiles_plain = counted_plain
    launches = 0
    ts.launches = 0
    try:
        for thr in (0.3, 0.65):
            torch.cuda.reset_peak_memory_stats()
            before = (ts.launches, engine.host_syncs)
            t0 = time.perf_counter()
            tree = BatchTree(
                N_FEATURES, threshold=thr, batch_size=8192, device="cuda",
                **FIT_SETTINGS[thr],
            )
            tree.fit_packed(dev_fps, range(N_FPS))
            ncl = tree.num_clusters
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            fit_launches = ts.launches - before[0]
            syncs = engine.host_syncs - before[1]
            rel = (ncl - JAX_COUNTS[thr]) / JAX_COUNTS[thr]
            say(
                f"phase 4 t={thr}: fit {wall:.2f} s, {N_FPS / wall:.0f} fps/s, "
                f"{ncl} clusters (JAX record {JAX_COUNTS[thr]}, rel diff {rel:+.5%}), "
                f"{syncs} host syncs, {fit_launches} kernel launches, peak "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated"
            )
            if fit_launches <= 0:
                raise AssertionError("the fit never launched the tile-search kernel")
            if plain_on_cuda:
                raise AssertionError("the plain search ran on CUDA tensors during the fit")
            if abs(rel) > 0.01:
                raise AssertionError(f"cluster count {ncl} is off the JAX record by {rel:+.3%}")
            _check_fit(tree, fps, thr)
            del tree
            torch.cuda.empty_cache()
        launches = ts.launches
    finally:
        ts.search_tiles_plain = plain
    return {"launches": launches}


def main() -> None:
    dev = phase_device()
    kern = phase_kernel()
    phase_cpu_vs_cuda()
    full = phase_full_size()
    kms, pms = kern["timing"]["few"]
    say(json.dumps({"kernels": [{
        "name": "tile_search_sorted",
        "route": "cuda",
        "source": "bblean_tpu_torch/csrc/tile_search.cu",
        "replaces": "bblean_tpu/ops/pallas_search2.py:61",
        "launches": full["launches"],
        "max_abs_err": kern["max_abs_err"],
        "ms": kms,
        "plain_ms": pms,
    }]}))
    say(dev["smi"])
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["kind"], "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
