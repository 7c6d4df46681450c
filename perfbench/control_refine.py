r"""The control of ``correct`` for a refined cell: ``perfbench/control.py`` with
its bfloat16 merge test widened to the refine's criterion.

A refined cell's job fits under the diameter criterion and refines under
tolerance-diameter.  The control here plants, for both, the merge test one
precision below the float32 the configurations state: iSIM, the
threshold and, for tolerance-diameter, the cluster's iSIM before the merge
and its tolerance, all rounded to bfloat16 (:func:`bfloat16_merge_test`).
Its refined clusterings must come out not correct.  Everything else (the
faults, the runs, the lines printed) is ``control.py``'s.

Run from the root of a checkout on the chip::

    python3 perfbench/control_refine.py --workload <cell> --sound <seed ...> \
        --control <seed ...> --faults <seed ...>
"""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import control  # noqa: E402

__all__ = ["bfloat16_merge_test"]


def bfloat16_merge_test(criterion, threshold, moments, new_n, old_n, nom_n, tolerance=0.05):
    r"""The diameter and tolerance-diameter merge tests in bfloat16."""
    import torch

    from bblean_tpu_torch.ops.isim import isim_from_moments
    from bblean_tpu_torch.ops.merges import _adaptive_tol

    if criterion == "diameter":
        return control.bfloat16_merge_test(criterion, threshold, moments, new_n, old_n, nom_n)
    if criterion != "tolerance-diameter":
        raise ValueError("the control plants diameter and tolerance-diameter only")
    bf = torch.bfloat16
    new_c = isim_from_moments(moments[0], moments[1], new_n).to(bf)
    old_c = torch.where(
        old_n < 2, 0.0, isim_from_moments(moments[2], moments[3], old_n.clamp_min(2))
    ).to(bf)
    thr = torch.as_tensor(threshold, dtype=torch.float32, device=new_c.device).to(bf)
    tol = _adaptive_tol(tolerance, old_n).to(bf)
    return (new_c >= thr) & ((old_n == 1) | (new_c >= old_c - tol))


def main(argv: list[str] | None = None) -> int:
    control.FAULTS["control"] = [
        (module, name, lambda _f: bfloat16_merge_test)
        for module, name, _make in control.FAULTS["control"]
    ]
    return control.main(argv)


if __name__ == "__main__":
    sys.exit(main())
