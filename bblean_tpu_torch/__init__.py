r"""bblean-tpu on PyTorch: the batch engine's fit path for CPU and CUDA.

A port of ``bblean_tpu``'s batched BitBirch engine (``BatchTree``) from JAX
to PyTorch.  On an NVIDIA GPU the in-group tile search runs a CUDA kernel
written for Hopper (``csrc/tile_search.cu``, built with ``nvcc`` at first
use); on the CPU it runs the kernel's plain PyTorch version.  The package
imports no JAX; it reuses the JAX-free host modules of ``bblean_tpu``.
"""

from bblean_tpu_torch.engine.batch import BatchState, BatchTree

__all__ = ["BatchTree", "BatchState"]
