r"""The per-batch group route's cost as the group count grows, on one card.

The twin of ``benchmarks/route_cost.py``.  The route
(``engine/batch.py::_route_groups``, ``ops/route.py::route_groups``) is
the first argmax Tanimoto of each of a step's M = 8192 rows over the live
group centroids, in blocks of ``block`` groups.  On the card it is one
call of the hand-written kernels of ``csrc/route.cu`` (a persistent int8
``wgmma`` product fed by TMA, with the Tanimoto and the argmax in its
epilogue, then a small kernel combining its column ranges);
its plain version runs each block as an int8 GEMM (``torch._int_mm``) of
the (M, F) 0/1 rows against the block's (block, F) 0/1 centroids followed
by about eight elementwise ops.  It runs once per batch step, and its work
grows with the groups: the 10M fits end on about 17,400 groups at t = 0.3
and 43,300 at t = 0.65.

Usage, from the repository root::

    python3 -m bblean_tpu_torch.benchmarks.route_cost [fps_per_s ...] [--block N] [--parent DIR]

For each live group count it prints, per call (CUDA events, median of 10,
the host's dispatch included): the kernel's ms, the plain version's ms on
the card, and ``torch._int_mm`` over the same live blocks (the product
alone, one call; the port never calls it); the bound (2 * M * G * F int8
operations over 1,979 TOP/s or the bytes read and written once over
3.35 TB/s, whichever is larger; H100 SXM data sheet) and the kernel's and
the plain version's share of it (bound / time); and, for each
``fps_per_s`` given (a fit's measured rate), the kernel's and the plain
version's share of a step of 8192 rows at that rate.  The kernel's routes
must equal the plain version's.  ``--parent DIR`` (a directory holding
another checkout's ``bblean_tpu_torch/``, e.g. ``git archive HEAD
bblean_tpu_torch | tar -x -C DIR`` in a directory ``.gitignore`` lists)
loads that port too, in the same process, and times its kernel beside
this one's in turns (parent, this, this, parent; each a median of 10
calls), and requires equal routes: the before-and-after table of a change
to the kernel, on one card.  The last line is one JSON object with the
table.  Without a CUDA device it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import torch

M = 8192
F = 2048
G_CAP = 1 << 16
# The 1M fit's average route (1,646), the 10M fits' average (22,000) and
# final counts (about 17,400 and 43,300), and the table full
G_LIVE = (1646, 4096, 8192, 16384, 17364, 22000, 32768, 43008, 65536)
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15


def _bound_ms(g_live: int) -> tuple[float, str]:
    r"""The least time for one route: rows, live centroids, both popcount
    vectors and the pending flags read once, the (M,) groups written once;
    or the product's multiply-adds at the int8 peak."""
    n_bytes = M * F + g_live * F + 4 * M + 4 * g_live + M + 4 * M
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = 2.0 * M * g_live * F / INT8_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def _median_ms(fn, reps: int = 10) -> float:
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


def _route_module(tree_dir: str):
    r"""``bblean_tpu_torch.ops.route`` imported afresh from ``tree_dir``,
    with its kernels built from that checkout's sources."""
    for name in [m for m in sys.modules if m.split(".")[0] == "bblean_tpu_torch"]:
        del sys.modules[name]
    tree_dir = os.path.abspath(tree_dir)
    sys.path.insert(0, tree_dir)
    try:
        from bblean_tpu_torch.ops import route

        if not route.__file__.startswith(tree_dir):
            raise AssertionError(f"imported {route.__file__}, not from {tree_dir}")
        route.kernel.lib()
    finally:
        sys.path.remove(tree_dir)
    return route


def _option(argv: list[str], name: str) -> tuple[str | None, list[str]]:
    if name not in argv:
        return None, argv
    i = argv.index(name)
    return argv[i + 1], argv[:i] + argv[i + 2 :]


def main(argv: list[str] | None = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        raise SystemExit("route_cost: torch.cuda.is_available() is False; no result")
    block, argv = _option(argv, "--block")
    block = 1024 if block is None else int(block)
    parent_dir, argv = _option(argv, "--parent")
    parent = None if parent_dir is None else _route_module(parent_dir)
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    route = _route_module(here) if parent is not None else None
    if route is None:
        from bblean_tpu_torch.ops import route
    rates = [float(a) for a in argv]
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip(), flush=True)

    rng = np.random.default_rng(0)
    dev = "cuda"
    row_cent = torch.from_numpy(rng.integers(0, 2, (M, F), dtype=np.int8)).to(dev)
    g_cent = torch.from_numpy(rng.integers(0, 2, (G_CAP, F), dtype=np.int8)).to(dev)
    row_pop = torch.from_numpy(rng.integers(600, 900, (M,)).astype(np.int32)).to(dev)
    g_pops = torch.from_numpy(rng.integers(600, 900, (G_CAP,)).astype(np.int32)).to(dev)
    pending = torch.ones((M,), dtype=torch.bool, device=dev)

    table = []
    for g_live in G_LIVE:
        args = (row_cent, row_pop, g_cent, g_pops, g_live, pending, block)
        launched = route.route_launches
        if not torch.equal(route.route_groups(*args), route.route_groups_plain(*args)):
            raise AssertionError(f"G={g_live}: the kernel's routes differ from the plain version's")
        if route.route_launches != launched + 1 or route.generic_launches:
            raise AssertionError(f"G={g_live}: the route did not launch its kernel")
        b = g_cent[: min(-(-g_live // block) * block, G_CAP)].t()
        ms = {}
        if parent is not None:
            if not torch.equal(parent.route_groups(*args), route.route_groups(*args)):
                raise AssertionError(f"G={g_live}: the parent's routes differ from this kernel's")
            turns = [parent, route, route, parent]
            times = [_median_ms(lambda: mod.route_groups(*args)) for mod in turns]
            ms["parent"] = float(np.median([times[0], times[3]]))
            ms["kernel"] = float(np.median([times[1], times[2]]))
        else:
            ms["kernel"] = _median_ms(lambda: route.route_groups(*args))
        ms["plain"] = _median_ms(lambda: route.route_groups_plain(*args))
        ms["int_mm"] = _median_ms(lambda: torch._int_mm(row_cent, b))
        bound, by = _bound_ms(g_live)
        step = M * 1e3  # ms of a step of M rows at 1 fps/s
        row = {
            "g_live": g_live, "blocks": -(-g_live // block), "ms": ms["kernel"],
            "plain_ms": ms["plain"], "library_ms": ms["int_mm"], "bound_ms": bound,
            "bound_by": by, "share": bound / ms["kernel"], "plain_share": bound / ms["plain"],
            "step_share": {str(r): ms["kernel"] / (step / r) for r in rates},
            "plain_step_share": {str(r): ms["plain"] / (step / r) for r in rates},
        }
        if parent is not None:
            row["parent_ms"] = ms["parent"]
            row["parent_share"] = bound / ms["parent"]
        table.append(row)
        steps = "".join(
            f"; of a step at {float(r):,.0f} fps/s: kernel {s:.1%}, plain "
            f"{row['plain_step_share'][r]:.1%}"
            for r, s in row["step_share"].items()
        )
        before = (
            f"parent {ms['parent']:8.4f} ms (share {row['parent_share']:.3f}), "
            if parent is not None else ""
        )
        print(
            f"G={g_live:6d} ({row['blocks']} blocks): {before}kernel {ms['kernel']:8.4f} ms, plain "
            f"{ms['plain']:8.4f} ms, torch._int_mm {ms['int_mm']:8.4f} ms a call; bound "
            f"{bound:.4f} ms ({by}), share kernel {row['share']:.3f} / plain "
            f"{row['plain_share']:.3f}{steps}",
            flush=True,
        )
    print(json.dumps({"block": block, "m": M, "f": F, "routes": table}), flush=True)


if __name__ == "__main__":
    main()
