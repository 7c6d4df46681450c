r"""fit.torch_ms: device time of the step's torch operations per million
rows fitted under the profiler: every kernel that no hand-kernel metric's
``KERNELS`` claims (``engine/batch.py``: cohesion, positions, tables,
unpacking, refresh, splits, and the torch around the hand kernels)."""

from perfbench import trace
from perfbench.observe import per_mrow


def read(obs):
    ns = trace.kernel_ns(obs.kernel_sums, obs.claimed, invert=True)
    return None if ns is None else per_mrow(ns / 1e6, obs.traced_rows)
