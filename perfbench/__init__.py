r"""Benchmark of the PyTorch and CUDA port (``bblean_tpu_torch``) on NVIDIA GPUs.

One run is one cell of ``BENCHMARK.json`` at the repository root::

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Configurations (``configs/<name>.json``), traffic mixes
(``traffic/<name>.json``), the loops that drive a traffic mix
(``drivers/<name>.py``) and per-layer metrics (``metrics/<name>.py``) are
found by the names in ``BENCHMARK.json``: a new cell, mix or metric is new
files and entries, never an edit.  Nothing here imports JAX or the JAX
package; the reference (``reference.py``) imports nothing of the port.
"""
