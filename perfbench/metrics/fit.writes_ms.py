r"""fit.writes_ms: device time of the insert rounds' pool and tile writes
per million rows fitted under the profiler (``ops/commit_writes.py``,
``csrc/commit_writes.cu``)."""

from perfbench.observe import kernel_reader

KERNELS = ("writes_sets_kernel", "writes_adds_cells_kernel")
read = kernel_reader(KERNELS)
