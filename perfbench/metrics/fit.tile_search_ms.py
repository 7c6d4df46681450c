r"""fit.tile_search_ms: device time of the in-group tile search per million
rows fitted under the profiler (``ops/tile_search.py``,
``csrc/tile_search.cu``: both front ends and the plan's item table)."""

from perfbench.observe import kernel_reader

KERNELS = ("tile_search_kernel", "plan_items_kernel")
read = kernel_reader(KERNELS)
