r"""Misc. utility helpers shared across the port.

Copies of the host helpers of ``bblean_tpu/utils.py`` (``min_safe_uint``,
``batched``, the CPU probes), with the accelerator names read from
``torch.cuda``.  The probes of the native C++ host engine are left out
until that engine is ported.
"""

from __future__ import annotations

import itertools
import os
import platform
import subprocess
import sys
import typing as tp
from pathlib import Path

import numpy as np

__all__ = ["batched", "min_safe_uint"]

_T = tp.TypeVar("_T")

# Thresholds at which a (positive) integer no longer fits each uint dtype
_UINT_STEPS: tuple[tuple[int, np.dtype], ...] = (
    (1 << 8, np.dtype(np.uint8)),
    (1 << 16, np.dtype(np.uint16)),
    (1 << 32, np.dtype(np.uint32)),
    (1 << 64, np.dtype(np.uint64)),
)


def min_safe_uint(nmax: int) -> np.dtype:
    r"""Smallest numpy uint dtype that can hold the positive integer ``nmax``."""
    for limit, dt in _UINT_STEPS:
        if nmax < limit:
            return dt
    raise ValueError(f"n_samples: {nmax} is too large to hold in a uint64 array")


def batched(iterable: tp.Iterable[_T], n: int) -> tp.Iterator[tuple[_T, ...]]:
    r"""Yield tuples of up to ``n`` consecutive items (itertools recipe)."""
    if n < 1:
        raise ValueError("n must be at least one")
    it = iter(iterable)
    while chunk := tuple(itertools.islice(it, n)):
        yield chunk


def _num_avail_cpus() -> int:
    if sys.platform == "darwin":
        return os.cpu_count() or 1
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:  # pragma: no cover - non-linux fallback
        return os.cpu_count() or 1


def _cpu_name() -> str:
    if sys.platform == "linux":
        try:
            with open("/proc/cpuinfo") as f:
                for line in f:
                    if line.startswith("model name"):
                        return line.split(":", 1)[1].strip()
        except OSError:
            pass
    if sys.platform == "darwin":  # pragma: no cover
        try:
            out = subprocess.run(
                ["sysctl", "-n", "machdep.cpu.brand_string"],
                capture_output=True,
                text=True,
                check=True,
            )
            return out.stdout.strip()
        except Exception:
            pass
    return platform.processor()


def _cuda_device_names() -> list[str]:
    r"""Names of the visible CUDA devices (empty when there is none)."""
    import torch

    if not torch.cuda.is_available():
        return []
    return [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]


def _has_files_or_valid_symlinks(path: Path) -> bool:
    has_files = False
    for p in path.iterdir():
        if p.is_symlink() and not p.exists():
            return False
        if p.is_file():
            has_files = True
    return has_files
