r"""Best practices: pick a threshold empirically, then refine.

The twin of ``examples/best_practices.py``.  The reference's
best-practices notebook scans thresholds on a subsample and inspects the
cluster-population / cohesion tradeoff; this module does the same on
synthetic data (swap in your own packed ``.npy`` to reproduce on a real
library).  ``BitBirch`` runs on the host engines (native C++, else
Python); ``--device`` is checked and names the device of the run.

    python3 -m bblean_tpu_torch.examples.best_practices [--device cpu]
"""

from __future__ import annotations

import typing as tp

import numpy as np

from bblean_tpu_torch import BitBirch
from bblean_tpu_torch.examples import parse_args
from bblean_tpu_torch.fingerprints import make_fake_fingerprints
from bblean_tpu_torch.metrics import jt_dbi, jt_isim_chi
from bblean_tpu_torch.similarity import jt_isim_from_sum


def main(argv: tp.Sequence[str] | None = None) -> None:
    parse_args(__doc__, argv)
    fps = make_fake_fingerprints(10_000, n_features=2048, seed=7)
    unpacked = np.unpackbits(fps, axis=1)

    # ---- 1. threshold scan on a subsample ---------------------------------
    print(f"{'t':>5} {'clusters':>9} {'>=10':>6} {'top':>6} {'iSIM(top)':>9}")
    for t in (0.20, 0.30, 0.40, 0.50, 0.65):
        tree = BitBirch(threshold=t).fit(fps)
        clusters = tree.get_cluster_mol_ids()
        sizes = np.array([len(c) for c in clusters])
        ls = unpacked[clusters[0]].astype(np.uint64).sum(0)
        isim = jt_isim_from_sum(ls, int(sizes[0])) if sizes[0] > 1 else 1.0
        print(
            f"{t:5.2f} {len(clusters):9d} {(sizes >= 10).sum():6d} "
            f"{sizes[0]:6d} {isim:9.3f}"
        )

    # Rule of thumb: sparse ECFP-like fingerprints cluster best at 0.3-0.4;
    # pick the threshold where big clusters appear but iSIM stays near t.

    # ---- 2. fit at the chosen threshold, compare quality metrics ----------
    threshold = 0.30
    tree = BitBirch(threshold=threshold).fit(fps)
    mol_ids = tree.get_cluster_mol_ids()
    cluster_fps = [fps[m] for m in mol_ids[:20] if len(m) >= 2]
    chi = jt_isim_chi(cluster_fps)
    dbi = jt_dbi(cluster_fps)
    print(f"\nt={threshold}: CHI={chi:.2f} DBI={dbi:.2f} (top-20 clusters)")

    # ---- 3. refinement with the tolerance criterion -----------------------
    # tolerance-diameter only accepts merges that do not degrade the old
    # cluster's cohesion by more than the (adaptively decayed) tolerance.
    tree.set_merge("tolerance-diameter", threshold=threshold, tolerance=0.05)
    tree.refine_inplace(fps, n_largest=10)
    sizes = np.array([len(c) for c in tree.get_cluster_mol_ids()])
    print(f"after refining 10 largest: {len(sizes)} clusters, top {sizes[:3]}")


if __name__ == "__main__":
    main()
