r"""refine.rows_ms: host wall of each refine's third stage, the exploded rows
read back from the library and fitted (``_load_rows_by_mol``,
``fit_packed``), per million library rows refined, over every refine of the
window (``bblean_tpu_torch/engine/batch.py``'s ``refine_rows_ns``).  None
where the program has no such counter."""

from perfbench.observe import per_mrow

COUNTERS = ("bblean_tpu_torch.engine.batch:refine_rows_ns",)


def read(obs):
    ns = obs.deltas.get(COUNTERS[0])
    return None if ns is None else per_mrow(ns / 1e6, obs.rows)
