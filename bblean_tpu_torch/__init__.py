r"""bblean-tpu on PyTorch: the batch engine (``BatchTree``) for CPU and CUDA.

A port of ``bblean_tpu``'s batched BitBirch engine from JAX to PyTorch:
fit, buffer insertion, refinement, reclustering, extraction and predict.
On an NVIDIA GPU the in-group tile search runs CUDA kernels written for
Hopper (``csrc/tile_search.cu``, built with ``nvcc`` at first use); on the
CPU it runs the kernels' plain PyTorch version.  The package imports
neither JAX nor ``bblean_tpu``: the host helpers it needs are copied into
``fingerprints.py``.
"""

from bblean_tpu_torch.engine.batch import BatchState, BatchTree

__all__ = ["BatchTree", "BatchState"]
