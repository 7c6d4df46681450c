r"""The control of ``correct``, the faults of its decisions, and the readings
its limits are set from.

The configurations state the merge test in float32 (the port's iSIM is
exact int64 moments and one float64 quotient rounded to float32).  The
control is that test one precision lower: the iSIM and the threshold it is
compared with both rounded to bfloat16 (:func:`bfloat16_merge_test`),
planted in the program in place of
``bblean_tpu_torch.ops.merges.merge_accept_from_moments`` for the
diameter criterion.  Its clusterings must come out not correct.

The faults break the insert round's decisions where they are made, in
``bblean_tpu_torch.engine.batch``, each on its own: ``merges refused``
(every individual and prefix merge test says no), ``no candidates`` (the
tile search finds no cluster for any row) and ``own leaders`` (the
election makes every rejected row a leader, so no rejected row joins
another).  Counts, sums and centroids stay exact under each, so only
``merge_share_gap`` can see them; at the cells' sizes it sees the first
two, and the third reads within the sound seeds' spread.

Run from the root of a checkout on the chip, at the cell's own size::

    python3 perfbench/control.py --workload <cell> --sound <seed ...> --control <seed ...> \
        --faults <seed ...>

It runs the cell once per seed in one process, each run one fit
(``--seconds 0``): the program as it is on the ``--sound`` seeds, the
control on the ``--control`` seeds and each fault on the ``--faults``
seeds, and prints one JSON line per run with every number the reference
compared; the last line gives, per number, the largest sound reading and
the smallest reading of the control and of each fault.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

__all__ = ["FAULTS", "bfloat16_merge_test", "planted"]


def bfloat16_merge_test(criterion, threshold, moments, new_n, old_n, nom_n, tolerance=0.05):
    r"""The diameter merge test with iSIM and threshold in bfloat16."""
    import torch

    from bblean_tpu_torch.ops.isim import isim_from_moments

    if criterion != "diameter":
        raise ValueError("the control plants the diameter criterion only")
    isim = isim_from_moments(moments[0], moments[1], new_n)
    thr = torch.as_tensor(threshold, dtype=torch.float32, device=isim.device)
    return isim.to(torch.bfloat16) >= thr.to(torch.bfloat16)


def _refused(real):
    def merge_test(*args, **kwargs):
        return real(*args, **kwargs) & False

    return merge_test


def _no_candidates(real):
    def search(*args, **kwargs):
        best_sim, best = real(*args, **kwargs)
        return best_sim.clamp_max(-2.0), best

    return search


def _own_leaders(real):
    def elect(rejected, *args, **kwargs):
        _leads, lead_of, best_lead_sim = real(rejected, *args, **kwargs)
        return rejected.clone(), lead_of, best_lead_sim.clamp_max(-2.0)

    return elect


# What each plant replaces: (module, name, the replacement made from the
# function it replaces)
FAULTS = {
    "control": [
        ("bblean_tpu_torch.engine.batch", "merge_accept_from_moments", lambda _f: bfloat16_merge_test),
        ("bblean_tpu_torch.ops.merges", "merge_accept_from_moments", lambda _f: bfloat16_merge_test),
    ],
    "merges refused": [("bblean_tpu_torch.engine.batch", "merge_accept_from_moments", _refused)],
    "no candidates": [
        ("bblean_tpu_torch.engine.batch", "tile_search_planned", _no_candidates),
        ("bblean_tpu_torch.engine.batch", "tile_search_rows", _no_candidates),
    ],
    "own leaders": [("bblean_tpu_torch.engine.batch", "elect_leaders", _own_leaders)],
}


@contextlib.contextmanager
def planted(kind: str = "control"):
    r"""The program with the control or a fault of :data:`FAULTS` planted
    (every tree built inside; trees built before keep their captures)."""
    import importlib

    saved = []
    try:
        for mod_name, name, make in FAULTS[kind]:
            mod = importlib.import_module(mod_name)
            saved.append((mod, name, getattr(mod, name)))
            setattr(mod, name, make(getattr(mod, name)))
        yield
    finally:
        for mod, name, real in reversed(saved):
            setattr(mod, name, real)


def main(argv: list[str] | None = None) -> int:
    from perfbench.run import run_cell

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--sound", type=int, nargs="*", default=[])
    ap.add_argument("--control", type=int, nargs="*", default=[])
    ap.add_argument("--faults", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    sides = [("sound", args.sound), ("control", args.control)]
    sides += [(kind, args.faults) for kind in FAULTS if kind != "control"]
    readings: dict[str, dict[str, list]] = {}
    for side, seeds in sides:
        with planted(side) if side != "sound" else contextlib.nullcontext():
            for seed in seeds:
                t0 = time.perf_counter()
                try:
                    result, lines = run_cell(
                        ROOT, args.workload, seed=seed, seconds=0, trace=False, t_start=t0,
                    )
                except Exception as exc:  # a plant that crashes the fit has failed
                    print(json.dumps({"side": side, "seed": seed, "crashed": repr(exc)}), flush=True)
                    continue
                got = {k: v["value"] for k, v in result["compared"].items()}
                for k, v in got.items():
                    readings.setdefault(side, {}).setdefault(k, []).append(v)
                print(json.dumps({
                    "side": side, "seed": seed, "correct": result["correct"], "compared": got,
                    "notes": lines[: -len(got)], "wall_s": time.perf_counter() - t0,
                }), flush=True)
    print(json.dumps({
        "workload": args.workload,
        "sound_largest": {k: max(v) for k, v in readings.get("sound", {}).items()},
        **{
            f"{side}_smallest": {k: min(v) for k, v in got.items()}
            for side, got in readings.items() if side != "sound"
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
