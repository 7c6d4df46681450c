r"""fit.graph_runs: the rounds' and split passes' device programs run per
million rows fitted (``bblean_tpu_torch/engine/graphs.py``: dispatched at
a key's first use, captured at its second, replayed after), over every
fit of the window."""

from perfbench.observe import per_mrow

COUNTERS = (
    "bblean_tpu_torch.engine.graphs:warmups",
    "bblean_tpu_torch.engine.graphs:captures",
    "bblean_tpu_torch.engine.graphs:replays",
)


def read(obs):
    return per_mrow(sum(obs.deltas[c] for c in COUNTERS), obs.rows)
