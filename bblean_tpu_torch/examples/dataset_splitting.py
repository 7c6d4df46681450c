r"""Cluster-aware train/test splitting.

The twin of ``examples/dataset_splitting.py``.  Random splits of molecular
datasets leak: near-duplicate analogues land on both sides and inflate
test scores.  Splitting by *cluster* keeps whole chemical series together.
This mirrors the reference's dataset-splitting example on synthetic data.
``BitBirch`` runs on the host engines (native C++, else Python);
``--device`` is checked and names the device of the run.

    python3 -m bblean_tpu_torch.examples.dataset_splitting [--device cpu]
"""

from __future__ import annotations

import typing as tp

import numpy as np

from bblean_tpu_torch import BitBirch
from bblean_tpu_torch.examples import parse_args
from bblean_tpu_torch.fingerprints import make_fake_fingerprints
from bblean_tpu_torch.similarity import jt_sim_packed


def main(argv: tp.Sequence[str] | None = None) -> None:
    parse_args(__doc__, argv)
    rng = np.random.default_rng(0)
    fps = make_fake_fingerprints(30_000, n_features=2048, seed=11)
    # Pretend property to predict (only used to show the split shapes)
    y = rng.normal(size=len(fps))

    # ---- 1. cluster at a threshold matched to the fingerprint kind --------
    tree = BitBirch(threshold=0.30).fit(fps)
    clusters = tree.get_cluster_mol_ids()  # largest first

    # ---- 2. greedy cluster -> fold assignment (balanced sizes) ------------
    test_frac = 0.2
    n_test_target = int(len(fps) * test_frac)
    test_idx: list[int] = []
    train_idx: list[int] = []
    # Walk clusters shuffled so the test set isn't all giant or all singleton
    order = rng.permutation(len(clusters))
    for ci in order:
        mols = clusters[ci]
        if len(test_idx) + len(mols) <= n_test_target:
            test_idx.extend(mols)
        else:
            train_idx.extend(mols)

    train = np.sort(np.asarray(train_idx))
    test = np.sort(np.asarray(test_idx))
    print(f"train {len(train)} / test {len(test)} ({len(test)/len(fps):.1%})")
    assert not np.intersect1d(train, test).size

    # ---- 3. verify the split is honest: cross-split similarity ------------
    # Max Tanimoto of each test molecule to the train set should be low
    # compared to a random split. Sample to keep the demo quick.
    sample = rng.choice(test, size=200, replace=False)
    train_sample = fps[rng.choice(train, size=5000, replace=False)]
    max_sims = np.array([jt_sim_packed(train_sample, fps[i]).max() for i in sample])
    rand_sample = rng.choice(len(fps), size=200, replace=False)
    rand_sims = np.array(
        [jt_sim_packed(train_sample, fps[i]).max() for i in rand_sample]
    )
    print(
        f"max train-similarity of test mols: median {np.median(max_sims):.3f} "
        f"(random split: {np.median(rand_sims):.3f})"
    )
    print(f"X_train {fps[train].shape}, y_train {y[train].shape}")


if __name__ == "__main__":
    main()
