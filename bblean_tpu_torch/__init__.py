r"""bblean-tpu on PyTorch: the ``BitBirch`` estimator with its host engines,
the batch engine (``BatchTree``) and the sharded engine
(``parallel.ShardedForest``) for CPU and CUDA.

A port of ``bblean_tpu`` from JAX to PyTorch.

- ``BitBirch`` (``tree.py``) is the library's front door: ``fit`` on the
  exact serial-equivalent host engine, refinement, reclustering, extraction,
  ``global_clustering`` (``method="kmeans-tpu"`` runs ``ops/kmeans.py`` on the
  CUDA device), ``save`` / ``load``.  Its insert loop runs in the native C++
  engine (``engine/native.py`` over ``csrc/bblean_native.cpp``, built with
  ``$CXX`` or ``g++`` at first use) and, where there is no compiler or
  ``BBLEAN_TPU_NO_EXTENSIONS=1`` is set, in the Python engine
  (``engine/exact.py``): the labels are the same, and ``BitBirch.engine_name``
  says which one runs.  Around it: ``similarity.py``, ``_np_similarity.py``,
  ``_merges.py``, ``metrics.py``, ``sklearn.py`` (the scikit-learn estimator;
  the only module that needs scikit-learn) and ``multiround.py`` (the
  multi-process workflow over many files).
- ``BatchTree`` (``engine/batch.py``) is the batched BitBirch engine on the
  device: fit, buffer insertion, refinement, reclustering, extraction and
  predict; ``parallel/`` is the sharded engine on top of it (one forest per
  shard of a mesh of devices, merged pairwise).  On an NVIDIA GPU the
  in-group tile search runs CUDA kernels written for Hopper
  (``csrc/tile_search.cu``, built with ``nvcc`` at first use); on the CPU it
  runs the kernels' plain PyTorch version.
- ``cli.py`` is the command line, with every command of ``bb`` (``run``
  with ``--engine exact``, the default, ``batch`` or ``sharded``;
  ``multiround``; the fingerprint file commands and ``fps-from-smiles``;
  ``summary`` and the ``plot-*`` commands; ``--version``), and
  ``ops/popcount.py``, ``ops/tanimoto.py``, ``ops/kmeans.py``,
  ``ops/tsne.py`` are the side-path ops.
- ``analysis.py``, ``plotting.py`` (matplotlib and seaborn imported by the
  drawing code only; the PCA and t-SNE embeddings are functions of their
  own, the t-SNE on the device) and ``_pca.py`` (the port's copy of what
  the plots use of scikit-learn's PCA) are the analysis side;
  ``smiles.py`` and ``fingerprints.py`` hold the SMILES featurization
  (RDKit, optional).  ``benchmarks/`` holds the 10M-row fit and the
  route's cost, run on a CUDA card.

Every device entry point runs on a CUDA device unless the caller asks for
the CPU (``_device.py``).  The package imports neither JAX nor
``bblean_tpu``: the host modules it needs are copied (besides those above,
``fingerprints.py``, ``smiles.py``, ``analysis.py``, ``utils.py``,
``_config.py``, ``_console.py``, ``_memory.py``, ``_timer.py``).  A pickle names its module, so a tree saved
by one package does not load in the other.
"""

from bblean_tpu_torch.engine.batch import BatchState, BatchTree
from bblean_tpu_torch.tree import BitBirch, set_merge

__version__ = "0.1.0"

__all__ = ["BitBirch", "set_merge", "BatchTree", "BatchState", "__version__"]
