r"""fit.h2d_ms: device time of host-to-device copies per million rows fitted
under the profiler (``BatchTree.fit_packed`` stages a host library in
chunks; the steps' small uploads count too)."""

from perfbench.observe import per_mrow


def read(obs):
    copies = [(s, e) for kind, name, s, e in obs.device or () if kind == "memcpy" and "HtoD" in name]
    if not copies:
        return None
    return per_mrow(sum(e - s for s, e in copies) / 1e6, obs.traced_rows)
