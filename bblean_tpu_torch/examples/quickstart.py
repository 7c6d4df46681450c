r"""Quickstart: cluster fingerprints, inspect the result, dump artifacts.

The twin of ``examples/quickstart.py``: the reference's quickstart notebook
on synthetic data, so it runs without RDKit.  With RDKit installed, replace
the generator with ``fps_from_smiles`` (or ``bb-torch fps-from-smiles
library.smi``).  ``BitBirch`` runs on the host engines (native C++, else
Python); ``--device`` is checked and names the device of the run.

    python3 -m bblean_tpu_torch.examples.quickstart [--device cpu]

It writes ``assignments.csv`` and ``tree.pkl`` into the working directory.
"""

from __future__ import annotations

import typing as tp

import numpy as np

from bblean_tpu_torch import BitBirch
from bblean_tpu_torch.examples import parse_args
from bblean_tpu_torch.fingerprints import make_fake_fingerprints
from bblean_tpu_torch.similarity import jt_isim_from_sum


def main(argv: tp.Sequence[str] | None = None) -> None:
    parse_args(__doc__, argv)

    # ---- inputs: packed uint8 fingerprints, shape (N, n_features/8) ------
    fps = make_fake_fingerprints(20_000, n_features=2048, seed=42)
    print(f"fingerprints: {fps.shape} packed uint8 ({fps.nbytes / 2**20:.0f} MB)")

    # ---- fit --------------------------------------------------------------
    # threshold 0.3 is the usual range for sparse (ECFP-like) fingerprints
    tree = BitBirch(threshold=0.30, merge_criterion="diameter")
    tree.fit(fps)

    # ---- inspect ----------------------------------------------------------
    clusters = tree.get_cluster_mol_ids()  # list of mol-id lists, largest first
    tree.get_assignments()  # (N,) 1-based labels
    tree.get_centroids()  # packed majority-vote centroids
    sizes = np.array([len(c) for c in clusters])

    print(f"{len(clusters)} clusters; largest {sizes[:5].tolist()}")
    print(f"singletons: {(sizes == 1).sum()} ({(sizes == 1).mean():.0%})")

    # Average in-cluster Tanimoto (iSIM) of the biggest cluster, O(N) from
    # the cluster's linear sum:
    big = np.asarray(fps[clusters[0]])
    ls = np.unpackbits(big, axis=1).astype(np.uint64).sum(0)
    print(f"largest cluster iSIM: {jt_isim_from_sum(ls, len(big)):.3f}")

    # ---- refinement: explode the largest cluster and refit ----------------
    tree.set_merge("tolerance-diameter", threshold=0.30)
    tree.refine_inplace(fps, n_largest=1)
    print(f"after refinement: {len(tree.get_cluster_mol_ids())} clusters")

    # ---- persistence -------------------------------------------------------
    tree.dump_assignments("assignments.csv")
    tree.save("tree.pkl")
    print("wrote assignments.csv, tree.pkl")


if __name__ == "__main__":
    main()
