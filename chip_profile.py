r"""Profile of the hand kernels inside one 1M-row fit on one NVIDIA GPU.

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
launches x (time - bound), the time above the bound per fit; and for the
prefix-commit kernel (``csrc/prefix_commit.cu``) its launches, device ms
per fit, the sum of its calls' bounds (``chip_smoke._prefix_bound``, from
the rows each call needs, and with ``cand_ls`` charged whole) and the time
above it, the same per call and width (screen, pass 1, pass 2 at 8,192 and
2,048 rows), beside the launches of ``torch.cumsum``'s outer-dimension
scan (none since the kernel replaced it), and the traffic of its calls
(the shares of the rows in the mask and in ``need`` and the longest run,
quartiles per call and width).  Those rows are logged
on the card (``chip_smoke._PrefixWork``) in a third fit, not profiled, so
the log's small kernels stay out of the profile; the fits are
deterministic, and its launches must equal the profiled fit's.  The device's
busy time in the profiled fit (every kernel and copy) and its share of the
fit's wall are printed too, and the idle share of each scan window on the
device: a marker kernel is launched as each window is dispatched, and a
window's period runs from its marker to the next.  Launches inside
replayed CUDA graphs (``engine/graphs.py``) are recorded from the capture's
inputs after each replay.  ``--out`` writes the per-launch and per-window
numbers to a JSON file.  The leader election's and the pool and tile
writes' kernels (``csrc/leader_election.cu``, ``csrc/commit_writes.cu``,
one call a round; three and two launches a call) get their calls and
device ms per fit, each launch's too, and so does the step's refresh
(``csrc/refresh.cu``, one call a step, two launches), with the sum of its
calls' bounds (``chip_smoke._refresh_bound``, noted in the logged fit)
and its share.  Imports no JAX.
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
    from bblean_tpu_torch.engine import batch as engine, graphs
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
    scan = engine._scan_fit_packed_impl

    def record(front, shape, key, order, pending):
        live = pending if order is None else pending[order]
        g = shape[0]
        grp = torch.where(key < 0, key + g, key).clamp(0, g - 1)
        records.append((front, shape, torch.where(live, grp, -1)))

    def recording(rows, pops, key, order, items, t_pk, t_pops, t_slot, pending):
        note = ("sorted" if order is not None else "rows", tuple(t_pk.shape), key, order, pending)
        if graphs.capturing is not None:
            # A capture launches nothing: its replays are recorded
            graphs.capturing.notes.setdefault("profile", []).append(note)
        else:
            record(*note)
        return launch(rows, pops, key, order, items, t_pk, t_pops, t_slot, pending)

    def replayed(prog, stage):
        # The noted key, order and pending are the step's buffers (not
        # written by the replay) or the replay's own temporaries
        if stage == "after":
            for note in prog.notes.get("profile", ()):
                record(*note)

    def marked(*args, **kwargs):
        torch.cuda._sleep(1)  # a marker kernel where the window reaches the device
        return scan(*args, **kwargs)

    ts._launch = recording
    engine._scan_fit_packed_impl = marked
    graphs.observers.append(replayed)
    try:
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof, cs._PrefixWork(log=False) as prefix:
            n_prof = _fit(dev_fps, thr)
        prof_wall = time.perf_counter() - t0
    finally:
        ts._launch = launch
        engine._scan_fit_packed_impl = scan
        graphs.observers.remove(replayed)
    if n_prof != n_plain:
        raise AssertionError(f"the profiled fit gave {n_prof} clusters, not {n_plain}")
    with cs._PrefixWork() as logged, cs._RefreshWork(bounds=True) as refresh_log:
        n_logged = _fit(dev_fps, thr)
    if n_logged != n_plain or [n[:4] for n in logged.seen] != [n[:4] for n in prefix.seen]:
        raise AssertionError("the logged fit's prefix-commit launches differ from the profiled fit's")

    events = sorted(
        (e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
        key=lambda e: e.time_range.start,
    )
    busy_ms = sum(e.time_range.elapsed_us() for e in events) / 1e3
    windows = _window_shares(events)
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
    summary["prefix-commit"] = _prefix_summary(events, logged)
    summary["leader-election"] = _round_kernel_summary(events, "leader election", cs.ELECTION_KERNELS)
    summary["commit-writes"] = _round_kernel_summary(events, "pool and tile writes", cs.WRITES_KERNELS)
    summary["refresh"] = _refresh_summary(events, refresh_log)
    cs.say(
        f"profile: profiled fit {prof_wall:.3f} s wall, device busy {busy_ms:.3f} ms "
        f"({busy_ms / 1e3 / prof_wall:.3f} of the wall); tile-search kernels "
        f"{sum(r['ms'] for r in per_launch):.3f} ms of it"
    )
    shares = [w["idle_share"] for w in windows]
    last = windows[-1]
    cs.say(
        f"profile: {len(windows)} scan windows on the device (from one marker kernel to "
        f"the next): idle share median {np.median(shares):.3f} (min {min(shares):.3f}, "
        f"max {max(shares):.3f}); the last full window {last['period_ms']:.1f} ms, "
        f"device busy {last['busy_ms']:.1f} ms, idle share {last['idle_share']:.3f}"
    )
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({
                "threshold": thr, "wall_s": wall, "profiled_wall_s": prof_wall,
                "busy_ms": busy_ms, "summary": summary, "launches": per_launch,
                "windows": windows,
            }, f)


def _prefix_summary(events, prefix) -> dict:
    r"""The prefix-commit kernel in the profiled fit: its launches (one a
    call), their device ms, the sums of the calls' bounds (``prefix``: the
    logged fit's launches, in the order they ran; the bound of the rows
    each call needs and the one with ``cand_ls`` read whole) and the time
    above them, in all and per (width, call); and the launches of
    ``torch.cumsum``'s outer-dimension scan, which it replaced."""
    kern = [e for e in events if any(k in e.name for k in cs.PREFIX_KERNELS)]
    launches = len(kern)
    if launches != len(prefix.seen):
        raise AssertionError(f"{launches} prefix-commit launches in the trace, {len(prefix.seen)} recorded")
    ms = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    bound, bound_full = prefix.bound_ms(), prefix.bound_ms(full=True)
    scans = [e for e in events if "scan_outer_dim" in e.name]
    out = {
        "launches": launches, "device_ms": ms, "bound_ms": bound, "above_bound_ms": ms - bound,
        "bound_full_ms": bound_full, "above_bound_full_ms": ms - bound_full,
        "mean_ms": ms / max(launches, 1), "wide_launches": sum(s[0] == 8192 for s in prefix.seen),
        "scan_outer_dim_launches": len(scans),
        "scan_outer_dim_ms": sum(e.time_range.elapsed_us() for e in scans) / 1e3,
        "traffic": prefix.traffic(), "calls": {},
    }
    rows = prefix.rows()
    for key in sorted({(n[0], n[3]) for n in prefix.seen}, key=lambda k: (-k[0], k[1])):
        pick = [i for i, n in enumerate(prefix.seen) if (n[0], n[3]) == key]
        call_ms = sum(kern[i].time_range.elapsed_us() for i in pick) / 1e3
        b = b_full = 0.0
        for i in pick:
            m, f, n_mom, call, _logged = prefix.seen[i]
            in_mask, _run, needed, read = (int(v) for v in rows[i])
            b += cs._prefix_bound(m, f, n_mom, call != "screen", read, needed)["bound_ms"]
            b_full += cs._prefix_bound(m, f, n_mom, call != "screen", in_mask)["bound_ms"]
        out["calls"][f"M={key[0]} {key[1]}"] = {
            "launches": len(pick), "device_ms": call_ms, "mean_ms": call_ms / len(pick),
            "bound_ms": b, "bound_full_ms": b_full,
        }
    cs.say(
        f"profile prefix-commit: {launches} launches ({out['wide_launches']} at M = 8192), "
        f"{ms:.3f} device ms per fit ({out['mean_ms']:.4f} ms a launch), bound {bound:.3f} ms, "
        f"time above bound {out['above_bound_ms']:.3f} ms (with cand_ls read whole: bound "
        f"{bound_full:.3f} ms, above it {out['above_bound_full_ms']:.3f} ms); torch.cumsum "
        f"outer-dimension scans: {len(scans)} launches, {out['scan_outer_dim_ms']:.3f} ms"
    )
    cs.say("profile prefix-commit per call: " + "; ".join(
        f"{k}: {v['launches']} launches, {v['device_ms']:.3f} ms ({v['mean_ms']:.4f} a launch), "
        f"bound {v['bound_ms']:.3f} ms ({v['bound_full_ms']:.3f} with cand_ls whole)"
        for k, v in out["calls"].items()
    ))
    cs.say(f"profile prefix-commit traffic: {prefix.traffic_text()}")
    return out


def _round_kernel_summary(events, label: str, names: tuple[str, ...]) -> dict:
    r"""A kernel of one call a round with one launch of each of ``names``
    (in launch order) a call in the profiled fit: its calls, their device
    ms per fit and a call's mean, and each launch's device ms."""
    by = {n: [e for e in events if n in e.name] for n in names}
    calls = len(by[names[0]])
    if any(len(v) != calls for v in by.values()):
        raise AssertionError(f"{label}: launches {[len(v) for v in by.values()]} are not one of each a call")
    per = {n: sum(e.time_range.elapsed_us() for e in v) / 1e3 for n, v in by.items()}
    ms = sum(per.values())
    out = {"calls": calls, "device_ms": ms, "mean_ms": ms / max(calls, 1), "by_kernel_ms": per}
    cs.say(
        f"profile {label}: {calls} calls ({len(names)} launches each), {ms:.3f} device ms per fit "
        f"({out['mean_ms']:.4f} ms a call; " + ", ".join(f"{n} {v:.3f} ms" for n, v in per.items()) + ")"
    )
    return out


def _refresh_summary(events, log) -> dict:
    r"""The step's refresh in the profiled fit (one call a step, two
    launches): its calls, device ms per fit, and the sum of the calls'
    bounds (``log``: the logged fit's calls, ``chip_smoke._refresh_bound``)
    with the share it makes of the device time."""
    out = _round_kernel_summary(events, "refresh", cs.REFRESH_KERNELS)
    if out["calls"] != log.calls:
        raise AssertionError(f"{out['calls']} refresh calls in the trace, {log.calls} in the logged fit")
    out["bound_ms"] = sum(log.bound_ms)
    out["share"] = out["bound_ms"] / out["device_ms"] if out["device_ms"] else 0.0
    cs.say(
        f"profile refresh: bound summed over the fit's calls {out['bound_ms']:.3f} ms, "
        f"share {out['share']:.3f} of its {out['device_ms']:.3f} device ms"
    )
    return out


def _window_shares(events) -> list[dict]:
    r"""Per scan window on the device, between consecutive marker kernels
    (``torch.cuda._sleep``'s ``spin_kernel``, launched as each window is
    dispatched): the period, the busy time of the device events that start
    in it, and the idle share 1 - busy / period."""
    marks = [e.time_range.start for e in events if "spin_kernel" in e.name]
    if len(marks) < 2:
        raise AssertionError(f"{len(marks)} window markers in the trace")
    out = []
    for a, b in zip(marks, marks[1:]):
        busy = sum(
            e.time_range.elapsed_us() for e in events
            if a <= e.time_range.start < b and "spin_kernel" not in e.name
        )
        out.append({
            "period_ms": (b - a) / 1e3, "busy_ms": busy / 1e3,
            "idle_share": 1.0 - busy / (b - a),
        })
    return out


if __name__ == "__main__":
    main()
