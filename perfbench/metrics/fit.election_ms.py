r"""fit.election_ms: device time of the insert rounds' leader election per
million rows fitted under the profiler (``ops/leader_election.py``,
``csrc/leader_election.cu``: compaction, leads, best leaders)."""

from perfbench.observe import kernel_reader

KERNELS = ("election_compact_kernel", "election_leads_kernel", "election_best_kernel")
read = kernel_reader(KERNELS)
