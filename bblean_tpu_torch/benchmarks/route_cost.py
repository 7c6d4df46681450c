r"""The per-batch group route's cost as the group count grows, on one card.

The twin of ``benchmarks/route_cost.py``.  The route
(``engine/batch.py::_route_groups``) is an argmax Tanimoto of each of a
step's M = 8192 rows over the live group centroids: blocks of ``block``
groups, each an int8 GEMM (``torch._int_mm``) of the (M, F) 0/1 rows
against the block's (block, F) 0/1 centroids plus a few elementwise ops.
It runs once per batch step, and its blocks grow with the groups: the 10M
fits end on 17,364 groups at t = 0.3 and 43,003 at t = 0.65.

Usage, from the repository root::

    python3 -m bblean_tpu_torch.benchmarks.route_cost [fps_per_s ...] [--block N]

For each live group count it prints the ms per call (CUDA events, median
of 10), the bound (2 * M * G * F int8 operations over 1,979 TOP/s or the
bytes read and written once over 3.35 TB/s, whichever is larger; H100 SXM
data sheet) and the call's share of it (bound / time), and, for each
``fps_per_s`` given (a fit's measured rate), the route's share of a step
of 8192 rows at that rate.  The last line is one JSON object with the
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
    r"""The least time for one route: rows, live centroids and both
    popcount vectors read once, the (M,) slots written once; or the
    GEMMs' multiply-adds at the int8 peak."""
    n_bytes = M * F + g_live * F + 4 * M + 4 * g_live + 4 * M
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = 2.0 * M * g_live * F / INT8_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def main(argv: list[str] | None = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        raise SystemExit("route_cost: torch.cuda.is_available() is False; no result")
    from bblean_tpu_torch.engine.batch import _route_groups

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
        def call():
            return _route_groups(row_cent, row_pop, g_cent, g_pops, g_live, pending, block)

        call()
        torch.cuda.synchronize()
        times = []
        for _ in range(10):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            call()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        ms = float(np.median(times))
        bound, by = _bound_ms(g_live)
        row = {
            "g_live": g_live, "blocks": -(-g_live // block), "ms": ms,
            "bound_ms": bound, "bound_by": by, "share": bound / ms,
            "step_share": {str(r): ms / (M / r * 1e3) for r in rates},
        }
        table.append(row)
        steps = "".join(
            f"; {s:.1%} of a step at {float(r):,.0f} fps/s" for r, s in row["step_share"].items()
        )
        print(
            f"G={g_live:6d} ({row['blocks']} blocks): {ms:8.3f} ms a call, bound "
            f"{bound:.4f} ms ({by}), share {bound / ms:.3f}{steps}",
            flush=True,
        )
    print(json.dumps({"block": block, "m": M, "f": F, "routes": table}), flush=True)


if __name__ == "__main__":
    main()
