r"""bblean-tpu on PyTorch: the batch engine (``BatchTree``) and the sharded
engine (``parallel.ShardedForest``) for CPU and CUDA.

A port of ``bblean_tpu``'s batched BitBirch engine from JAX to PyTorch:
fit, buffer insertion, refinement, reclustering, extraction and predict,
the sharded engine on top of it (``parallel/``: one forest per shard of a
mesh of devices, merged pairwise), their command line (``cli.py``: ``run
--engine batch``, ``run --engine sharded`` and the fingerprint file
commands) and the side-path ops (``ops/popcount.py``,
``ops/tanimoto.py``, ``ops/kmeans.py``, ``ops/tsne.py``).
On an NVIDIA GPU the in-group tile search runs CUDA kernels written for
Hopper (``csrc/tile_search.cu``, built with ``nvcc`` at first use); on the
CPU it runs the kernels' plain PyTorch version.  Every entry point runs on
a CUDA device unless the caller asks for the CPU (``_device.py``).  The
package imports neither JAX nor ``bblean_tpu``: the host modules it needs
are copied (``fingerprints.py``, ``utils.py``, ``_config.py``,
``_console.py``, ``_memory.py``, ``_timer.py``).
"""

from bblean_tpu_torch.engine.batch import BatchState, BatchTree

__all__ = ["BatchTree", "BatchState"]
