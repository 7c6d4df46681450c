r"""refine.h2d_ms: device time of host-to-device copies per million library
rows refined under the profiler (``BatchTree.refine_inplace``: the
survivors' buffer batches, 64 MiB of int32 sums each at 8,192 x 2048 bits,
the exploded rows' staging and the steps' small uploads); ``fit.h2d_ms``'s
reader, over the refine's trace."""

from pathlib import Path

from perfbench.manifest import load_module

read = load_module(Path(__file__).with_name("fit.h2d_ms.py")).read
