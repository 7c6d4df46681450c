r"""refine.extract_ms: host wall of each refine's first stage (every cluster's
size, dense linear sums and members pulled to the host, the survivors' int64
buffer array built, the tree reset) per million library rows refined, over
every refine of the window (``bblean_tpu_torch/engine/batch.py``'s
``refine_extract_ns``).  None where the program has no such counter."""

from perfbench.observe import per_mrow

COUNTERS = ("bblean_tpu_torch.engine.batch:refine_extract_ns",)


def read(obs):
    ns = obs.deltas.get(COUNTERS[0])
    return None if ns is None else per_mrow(ns / 1e6, obs.rows)
