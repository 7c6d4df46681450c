r"""Misc. utility helpers shared across the port.

Copies of the host helpers of ``bblean_tpu/utils.py`` (``min_safe_uint``,
``batched``, the CPU probes), with the accelerator names read from
``torch.cuda``, and the probes of the native C++ host engine (the same
``BBLEAN_TPU_NO_EXTENSIONS`` switch as ``bblean_tpu``, so one environment
drives both packages).
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

__all__ = [
    "batched",
    "min_safe_uint",
    "native_extensions_are_enabled",
    "native_extensions_are_installed",
]

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


def extensions_disabled_by_env() -> bool:
    r"""True when the native-extension kill switch is set (and not set to a
    false-y value: ``BBLEAN_TPU_NO_EXTENSIONS=0`` means *enabled*)."""
    off = ("", "0", "false", "False")
    return (
        os.getenv("BBLEAN_TPU_NO_EXTENSIONS", "") not in off
        or os.getenv("BITBIRCH_NO_EXTENSIONS", "") not in off
    )


def native_extensions_are_enabled() -> bool:
    r"""Whether the native (C++) host engine is built and not disabled."""
    if extensions_disabled_by_env():
        return False
    return native_extensions_are_installed()


def native_extensions_are_installed() -> bool:
    r"""Whether the native (C++) host library has been built (it is built at
    its first use; nothing is built here)."""
    from bblean_tpu_torch._native import native_lib_path

    return native_lib_path() is not None


# Backwards-compatible aliases matching the reference public names
cpp_extensions_are_enabled = native_extensions_are_enabled
cpp_extensions_are_installed = native_extensions_are_installed
