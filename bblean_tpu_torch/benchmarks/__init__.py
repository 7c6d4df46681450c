r"""Benchmarks of the port that mean something on a CUDA card: the
north-star fit at 10M rows (``scale_10m``) and the group route's cost as
the group count grows (``route_cost``).  Run each as a module from the
repository root, e.g. ``python3 -m bblean_tpu_torch.benchmarks.scale_10m``;
both refuse to run without a CUDA device."""
