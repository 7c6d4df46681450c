r"""One run of one cell of ``BENCHMARK.json``, on the CUDA devices of this
machine.

From the root of a checkout::

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell names a configuration and a traffic mix; the mix names the loop
that runs it (``perfbench/drivers/<name>.py``).  The last line of standard
output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (with ``--trace 0`` the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, each ``{"value", "unit"}``),
``device`` and, with ``--trace 1``, ``breakdown``; its last key,
``compared``, gives each number the reference compared beside its limit,
and the last lines of standard error say the same.  Without enough CUDA
devices, or with JAX or the JAX package loaded once the window has closed,
it exits non-zero and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import manifest  # noqa: E402

# Top-level modules that may not be loaded in a run (the port's own name
# begins with the last one's, so names are compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "bblean_tpu")


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(
    root: Path, cell: str, *, seed: int, seconds: float, trace: bool,
    device: str = "cuda", t_start: float | None = None, tree_cls: type | None = None,
) -> tuple[dict, list[str]]:
    r"""The result object and the lines that compare, for one run of
    ``cell`` on ``device`` (the chip check is the caller's)."""
    man = manifest.load(root)
    w = man.workloads[cell]
    config, traffic = man.config(w["config"]), man.traffic(w["traffic"])
    layer = {m["name"]: (m, man.metric(m["name"])) for m in man.per_layer_of(cell)}
    claimed = tuple(
        k for m in man.data["per_layer"] for k in getattr(man.metric(m["name"]), "KERNELS", ())
    )
    counters = sorted({c for _m, mod in layer.values() for c in getattr(mod, "COUNTERS", ())})
    out = man.driver(traffic["driver"]).run(
        config, traffic, seed=seed, seconds=seconds, trace_on=trace, device=device,
        t_start=T_START if t_start is None else t_start, counters=counters,
        claimed=claimed, tree_cls=tree_cls,
    )
    metrics = {}
    if trace:
        for name, (m, mod) in layer.items():
            value = mod.read(out["observation"])
            if value is not None:
                metrics[name] = {"value": value, "unit": m["unit"]}
    else:
        for m in man.end_to_end_of(cell):
            if m["name"] in out["end_to_end"]:
                metrics[m["name"]] = {"value": out["end_to_end"][m["name"]], "unit": m["unit"]}
    dev = {"platform": "gpu", "count": w["chips"], "memory_peak_bytes": out["memory_peak_bytes"]}
    if device == "cuda":
        import torch

        dev["kind"] = torch.cuda.get_device_name(0)
    dev.update(out.get("device", {}))
    result = {
        "correct": out["correct"], "attempted": out["attempted"], "failed": out["failed"],
        "metrics": metrics, "device": dev,
    }
    if "breakdown" in out:
        result["breakdown"] = out["breakdown"]
    result["compared"] = {k: {"value": v, "limit": lim} for k, v, lim in out["compared"]}
    lines = [f"fits: {len(out['walls'])}, walls {out['walls']} s", *out.get("notes", ())]
    lines += [f"compared {k}: {v!r} (limit {lim!r})" for k, v, lim in out["compared"]]
    return result, lines


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    man = manifest.load(ROOT)
    if args.workload not in man.workloads:
        print(f"perfbench: no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    chips = man.workloads[args.workload]["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(
            f"perfbench: cell {args.workload} needs {chips} CUDA device(s); "
            f"torch.cuda.is_available()={torch.cuda.is_available()}, "
            f"device_count={torch.cuda.device_count()}; no result",
            file=sys.stderr,
        )
        return 2
    result, lines = run_cell(
        ROOT, args.workload, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
    )
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: loaded in this process: {', '.join(bad)}; no result", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
