r"""The per-batch group route's cost as the group count grows, on one card.

The twin of ``benchmarks/route_cost.py``.  The route
(``engine/batch.py::_route_groups``, ``ops/route.py::route_groups``) is
the first argmax Tanimoto of each of a step's M = 8192 rows over the live
group centroids, in blocks of ``block`` groups.  On the card it is one
launch of the hand-written kernel of ``csrc/route.cu`` (an int8
tensor-core product with the Tanimoto and the argmax in its epilogue);
its plain version runs each block as an int8 GEMM (``torch._int_mm``) of
the (M, F) 0/1 rows against the block's (block, F) 0/1 centroids followed
by about eight elementwise ops.  It runs once per batch step, and its work
grows with the groups: the 10M fits end on about 17,400 groups at t = 0.3
and 43,300 at t = 0.65.

Usage, from the repository root::

    python3 -m bblean_tpu_torch.benchmarks.route_cost [fps_per_s ...] [--block N]

For each live group count it prints, per call (CUDA events, median of 10,
the host's dispatch included): the kernel's ms, the plain version's ms on
the card, and ``torch._int_mm`` over the same live blocks (the product
alone, one call; the port never calls it); the bound (2 * M * G * F int8
operations over 1,979 TOP/s or the bytes read and written once over
3.35 TB/s, whichever is larger; H100 SXM data sheet) and the kernel's and
the plain version's share of it (bound / time); and, for each
``fps_per_s`` given (a fit's measured rate), the kernel's and the plain
version's share of a step of 8192 rows at that rate.  The kernel's routes
must equal the plain version's.  The last line is one JSON object with the
table.  Without a CUDA device it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import torch

M = 8192
F = 2048
G_CAP = 1 << 16
G_LIVE = (4096, 8192, 16384, 17364, 32768, 43008, 65536)
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


def main(argv: list[str] | None = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        raise SystemExit("route_cost: torch.cuda.is_available() is False; no result")
    from bblean_tpu_torch.ops import route

    block = 1024
    if "--block" in argv:
        i = argv.index("--block")
        block = int(argv[i + 1])
        argv = argv[:i] + argv[i + 2 :]
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
        ms = {
            "kernel": _median_ms(lambda: route.route_groups(*args)),
            "plain": _median_ms(lambda: route.route_groups_plain(*args)),
            "int_mm": _median_ms(lambda: torch._int_mm(row_cent, b)),
        }
        bound, by = _bound_ms(g_live)
        step = M * 1e3  # ms of a step of M rows at 1 fps/s
        row = {
            "g_live": g_live, "blocks": -(-g_live // block), "ms": ms["kernel"],
            "plain_ms": ms["plain"], "library_ms": ms["int_mm"], "bound_ms": bound,
            "bound_by": by, "share": bound / ms["kernel"], "plain_share": bound / ms["plain"],
            "step_share": {str(r): ms["kernel"] / (step / r) for r in rates},
            "plain_step_share": {str(r): ms["plain"] / (step / r) for r in rates},
        }
        table.append(row)
        steps = "".join(
            f"; of a step at {float(r):,.0f} fps/s: kernel {s:.1%}, plain "
            f"{row['plain_step_share'][r]:.1%}"
            for r, s in row["step_share"].items()
        )
        print(
            f"G={g_live:6d} ({row['blocks']} blocks): kernel {ms['kernel']:8.4f} ms, plain "
            f"{ms['plain']:8.4f} ms, torch._int_mm {ms['int_mm']:8.4f} ms a call; bound "
            f"{bound:.4f} ms ({by}), share kernel {row['share']:.3f} / plain "
            f"{row['plain_share']:.3f}{steps}",
            flush=True,
        )
    print(json.dumps({"block": block, "m": M, "f": F, "routes": table}), flush=True)


if __name__ == "__main__":
    main()
