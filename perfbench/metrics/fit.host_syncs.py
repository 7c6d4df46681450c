r"""fit.host_syncs: the host driver's device-to-host reads per million rows
fitted (``bblean_tpu_torch/engine/batch.py``'s ``host_syncs``: round-loop
conditions, split predicates, live-group counts, flush-boundary pulls),
over every fit of the window."""

from perfbench.observe import per_mrow

COUNTERS = ("bblean_tpu_torch.engine.batch:host_syncs",)


def read(obs):
    return per_mrow(obs.deltas[COUNTERS[0]], obs.rows)
