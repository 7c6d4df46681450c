r"""fit.route_ms: device time of the group route per million rows fitted
under the profiler (``ops/route.py``, ``csrc/route.cu``: the TMA and
wgmma kernel, the generic kernel, and the kernel that combines column
ranges)."""

from perfbench.observe import kernel_reader

KERNELS = ("route_wgmma_kernel", "route_kernel", "route_combine_kernel")
read = kernel_reader(KERNELS)
