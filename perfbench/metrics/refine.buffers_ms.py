r"""refine.buffers_ms: host wall of each refine's second stage, the survivors
re-inserted as CF buffers (``BatchTree.insert_buffers``: each batch padded,
copied to the device, prepared and stepped), per million library rows
refined, over every refine of the window
(``bblean_tpu_torch/engine/batch.py``'s ``refine_buffers_ns``).  None where
the program has no such counter."""

from perfbench.observe import per_mrow

COUNTERS = ("bblean_tpu_torch.engine.batch:refine_buffers_ns",)


def read(obs):
    ns = obs.deltas.get(COUNTERS[0])
    return None if ns is None else per_mrow(ns / 1e6, obs.rows)
