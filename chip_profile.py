r"""Profile of the tile-search kernels inside one 1M-row fit on one NVIDIA GPU.

Run from the repository root:
``python3 chip_profile.py [--threshold 0.3] [--out PATH]``.
It fits the 1M x 2048-bit input of ``chip_smoke.py`` phase 4 once without
the profiler (wall time, counts), then once more under ``torch.profiler``
(CUDA activity only) while recording, for each tile-search launch, the
routed group of every pending row.  After the fit it reads those records
on the host and prints, per front end (sorted and per-row): launches, the
kernel's device milliseconds per fit, the mean pending rows and distinct
tiles per launch, the sum of the launches' bounds (``chip_smoke._bound``:
bytes over 3.35 TB/s or operations over 1,979 TOP/s) and
launches x (time - bound), the time above the bound per fit.  The device's
busy time in the profiled fit (every kernel and copy) and its share of the
fit's wall are printed too.  ``--out`` writes the per-launch numbers to
a JSON file.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

import chip_smoke as cs


def _fit(dev_fps, threshold):
    from bblean_tpu_torch import BatchTree

    tree = BatchTree(
        cs.N_FEATURES, threshold=threshold, batch_size=8192, device="cuda",
        **cs.FIT_SETTINGS[threshold],
    )
    tree.fit_packed(dev_fps, range(cs.N_FPS))
    n = tree.num_clusters
    torch.cuda.synchronize()
    return n


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--threshold", type=float, default=0.3, choices=sorted(cs.FIT_SETTINGS))
    ap.add_argument("--out", help="JSON file for the per-launch numbers")
    args = ap.parse_args()
    thr = args.threshold
    cs.phase_device()
    from bblean_tpu_torch.fingerprints import make_fake_fingerprints
    from bblean_tpu_torch.ops import tile_search as ts
    from torch.profiler import ProfilerActivity, profile

    fps = make_fake_fingerprints(cs.N_FPS, cs.N_FEATURES, seed=cs.SEED)
    dev_fps = torch.from_numpy(fps).to("cuda")
    del fps
    t0 = time.perf_counter()
    n_plain = _fit(dev_fps, thr)
    wall = time.perf_counter() - t0
    cs.say(f"profile: unprofiled 1M fit at t={thr}: {wall:.3f} s, {n_plain} clusters")

    records = []
    launch = ts._launch

    def recording(rows, pops, key, order, items, t_pk, t_pops, t_slot, pending):
        live = pending if order is None else pending[order]
        g = t_pk.shape[0]
        grp = torch.where(key < 0, key + g, key).clamp(0, g - 1)
        records.append((
            "sorted" if order is not None else "rows", tuple(t_pk.shape),
            torch.where(live, grp, -1),
        ))
        return launch(rows, pops, key, order, items, t_pk, t_pops, t_slot, pending)

    ts._launch = recording
    try:
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            n_prof = _fit(dev_fps, thr)
        prof_wall = time.perf_counter() - t0
    finally:
        ts._launch = launch
    if n_prof != n_plain:
        raise AssertionError(f"the profiled fit gave {n_prof} clusters, not {n_plain}")

    events = sorted(
        (e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
        key=lambda e: e.time_range.start,
    )
    busy_ms = sum(e.time_range.elapsed_us() for e in events) / 1e3
    kern = [e for e in events if "tile_search_kernel" in e.name]
    if len(kern) != len(records):
        raise AssertionError(f"{len(kern)} kernels in the trace, {len(records)} launches recorded")

    per_launch = []
    for e, (front, shape, grp) in zip(kern, records):
        # The sorted front end runs the 8-warp instance, the per-row one 4
        eight = any(x in e.name for x in ("Li8E", "true, 8>", "false, 8>"))
        if eight != (front == "sorted"):
            raise AssertionError(f"launch order mismatch at {e.name}")
        grp = grp.cpu().numpy()
        live = grp >= 0
        pend = torch.from_numpy(live)
        b = cs._bound(torch.from_numpy(np.where(live, grp, 0)), pend, shape)
        per_launch.append({
            "front": front, "ms": e.time_range.elapsed_us() / 1e3, "m": len(grp),
            "pending": b["pending"], "tiles": b["tiles"], "bound_ms": b["bound_ms"],
            "bound_by": b["bound_by"],
        })

    summary = {}
    for front in ("sorted", "rows"):
        rs = [r for r in per_launch if r["front"] == front]
        ms = sum(r["ms"] for r in rs)
        bound = sum(r["bound_ms"] for r in rs)
        summary[front] = {
            "launches": len(rs), "device_ms": ms, "bound_ms": bound,
            "above_bound_ms": ms - bound,
            "mean_ms": ms / max(len(rs), 1),
            "mean_pending": float(np.mean([r["pending"] for r in rs])) if rs else 0.0,
            "mean_tiles": float(np.mean([r["tiles"] for r in rs])) if rs else 0.0,
            "bytes_bound_launches": sum(r["bound_by"] == "bytes" for r in rs),
        }
        s = summary[front]
        cs.say(
            f"profile {front}: {s['launches']} launches, {s['device_ms']:.3f} device ms per "
            f"fit ({s['mean_ms']:.4f} ms a launch), {s['mean_pending']:.1f} pending rows "
            f"on {s['mean_tiles']:.1f} tiles a launch, bound {s['bound_ms']:.3f} ms "
            f"({s['bytes_bound_launches']} launches bound by bytes), launches x "
            f"(time - bound) = {s['above_bound_ms']:.3f} ms"
        )
    cs.say(
        f"profile: profiled fit {prof_wall:.3f} s wall, device busy {busy_ms:.3f} ms "
        f"({busy_ms / 1e3 / prof_wall:.3f} of the wall); tile-search kernels "
        f"{sum(r['ms'] for r in per_launch):.3f} ms of it"
    )
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({
                "threshold": thr, "wall_s": wall, "profiled_wall_s": prof_wall,
                "busy_ms": busy_ms, "summary": summary, "launches": per_launch,
            }, f)


if __name__ == "__main__":
    main()
