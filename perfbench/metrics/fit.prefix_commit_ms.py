r"""fit.prefix_commit_ms: device time of the insert rounds' prefix commits
per million rows fitted under the profiler (``ops/prefix_commit.py``,
``csrc/prefix_commit.cu``)."""

from perfbench.observe import kernel_reader

KERNELS = ("prefix_commit_kernel",)
read = kernel_reader(KERNELS)
