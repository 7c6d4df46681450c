r"""Host memory management: streaming mmap loads, RSS monitoring, and the
device's memory statistics.

A copy of ``bblean_tpu/_memory.py`` with the device part on ``torch.cuda``:

- ``_mmap_file_and_madvise_sequential`` maps a ``.npy`` read-only and advises
  the kernel of sequential access.
- ``_ArrayMemPagesManager`` releases consumed 2 MiB super-pages with
  ``madvise(DONTNEED)`` while a fit loop streams over a mapped array,
  keeping resident memory flat.
- ``launch_monitor_rss_daemon`` samples process-tree RSS into
  ``monitor-rss.csv`` / ``max-rss.txt``.
- ``device_memory_stats`` snapshots the CUDA caching allocator (current and
  peak bytes allocated and reserved, the card's total) for ``config.json``
  and the console summary.

Host memory is read with ``psutil`` where it is installed and from
``/proc`` where it is not.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import enum
import mmap
import multiprocessing as mp
import os
import sys
import time
import typing as tp
from pathlib import Path

import numpy as np
from numpy.typing import NDArray

__all__ = ["system_mem_gib", "launch_monitor_rss_daemon", "device_memory_stats"]

# Release granularity: 512 hardware pages (2 MiB with 4 KiB pages)
_SUPER_PAGE_BYTES = mmap.PAGESIZE * 512


class Madv(enum.IntEnum):
    NORMAL = 0
    RANDOM = 1
    SEQUENTIAL = 2
    WILLNEED = 3
    DONTNEED = 4


def _libc() -> ctypes.CDLL | None:
    if sys.platform != "linux":
        return None
    try:
        return ctypes.CDLL(ctypes.util.find_library("c"), use_errno=True)
    except OSError:  # pragma: no cover
        return None


def _madvise(addr: int, length: int, advice: Madv) -> None:
    lib = _libc()
    if lib is None:
        return
    # Align the start address down to a page boundary
    aligned = addr - (addr % mmap.PAGESIZE)
    length += addr - aligned
    lib.madvise(ctypes.c_void_p(aligned), ctypes.c_size_t(length), int(advice))


def _proc_meminfo_kib(*fields: str) -> list[int]:
    r"""The named fields of ``/proc/meminfo`` in KiB (0 where absent)."""
    found = dict.fromkeys(fields, 0)
    try:
        with open("/proc/meminfo", encoding="utf-8") as f:
            for line in f:
                name, _, rest = line.partition(":")
                if name in found:
                    found[name] = int(rest.split()[0])
    except OSError:
        pass
    return [found[name] for name in fields]


def system_mem_gib() -> tuple[float, float]:
    r"""(total, available) system memory in GiB."""
    try:
        import psutil
    except ImportError:
        total, avail = _proc_meminfo_kib("MemTotal", "MemAvailable")
        return total / 2**20, avail / 2**20
    vm = psutil.virtual_memory()
    return vm.total / 2**30, vm.available / 2**30


def device_memory_stats(device: tp.Any = "cuda") -> dict[str, int] | None:
    r"""Memory statistics of a CUDA ``device``; None for the CPU.

    ``bytes_in_use`` / ``peak_bytes_in_use`` are the caching allocator's
    allocated bytes, ``bytes_reserved`` / ``peak_bytes_reserved`` what it
    has reserved on the card, ``bytes_limit`` the card's total memory.
    """
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    return {
        "bytes_in_use": int(torch.cuda.memory_allocated(dev)),
        "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(dev)),
        "bytes_reserved": int(torch.cuda.memory_reserved(dev)),
        "peak_bytes_reserved": int(torch.cuda.max_memory_reserved(dev)),
        "bytes_limit": int(torch.cuda.get_device_properties(dev).total_memory),
    }


def _mmap_file_and_madvise_sequential(
    path: Path, max_fps: int | None = None
) -> NDArray[np.integer]:
    r"""Memory-map a ``.npy`` file read-only with sequential access advice."""
    arr = np.load(path, mmap_mode="r")
    if max_fps is not None:
        arr = arr[:max_fps]
    if isinstance(arr, np.memmap):
        _madvise(arr.ctypes.data, arr.nbytes, Madv.SEQUENTIAL)
    return arr


class _ArrayMemPagesManager:
    r"""Release already-consumed super-pages of a mapped array during a scan."""

    def __init__(self, arr: NDArray[np.integer], can_release: bool) -> None:
        self._arr = arr
        self.can_release = can_release and isinstance(arr, np.memmap)
        if len(arr) and arr.ndim == 2:
            self._rows_per_page = max(_SUPER_PAGE_BYTES // max(arr.strides[0], 1), 1)
        else:
            self._rows_per_page = 1 << 62
        self._page_start_row = 0

    @classmethod
    def from_bb_input(
        cls, X: tp.Any, can_release: bool = True
    ) -> "_ArrayMemPagesManager":
        if isinstance(X, np.ndarray):
            return cls(X, can_release)
        return cls(np.empty((0, 0), dtype=np.uint8), False)

    def should_release_curr_page(self, rows_consumed: int) -> bool:
        return rows_consumed - self._page_start_row >= self._rows_per_page

    def release_curr_page_and_update_addr(self) -> None:
        start = self._page_start_row
        end = start + self._rows_per_page
        base = self._arr.ctypes.data + start * self._arr.strides[0]
        _madvise(base, (end - start) * self._arr.strides[0], Madv.DONTNEED)
        self._page_start_row = end


def _proc_tree_rss(parent_pid: int) -> int | None:
    r"""RSS in bytes of ``parent_pid`` and its descendants, read from
    ``/proc``; None once the parent is gone."""

    def rss_of(pid: int) -> int | None:
        try:
            with open(f"/proc/{pid}/statm", encoding="utf-8") as f:
                return int(f.read().split()[1]) * mmap.PAGESIZE
        except (OSError, IndexError, ValueError):
            return None

    def children_of(pid: int) -> list[int]:
        kids: list[int] = []
        try:
            tasks = os.listdir(f"/proc/{pid}/task")
        except OSError:
            return kids
        for tid in tasks:
            try:
                with open(f"/proc/{pid}/task/{tid}/children", encoding="utf-8") as f:
                    kids += [int(c) for c in f.read().split()]
            except OSError:
                pass
        return kids

    total = rss_of(parent_pid)
    if total is None:
        return None
    todo = children_of(parent_pid)
    while todo:
        pid = todo.pop()
        total += rss_of(pid) or 0
        todo += children_of(pid)
    return total


def _psutil_tree_rss(psutil: tp.Any, parent_pid: int) -> int | None:
    try:
        parent = psutil.Process(parent_pid)
        procs = [parent] + parent.children(recursive=True)
    except psutil.NoSuchProcess:
        return None
    rss = 0
    for p in procs:
        try:
            rss += p.memory_info().rss
        except psutil.NoSuchProcess:
            pass
    return rss


def _monitor_rss(out_dir: Path, parent_pid: int, interval_s: float) -> None:
    try:
        import psutil
    except ImportError:
        tree_rss = _proc_tree_rss
    else:
        def tree_rss(pid: int) -> int | None:
            return _psutil_tree_rss(psutil, pid)

    csv_path = Path(out_dir) / "monitor-rss.csv"
    max_path = Path(out_dir) / "max-rss.txt"
    max_rss = 0
    t0 = time.monotonic()
    with open(csv_path, "wt", encoding="utf-8") as f:
        f.write("time_s,rss_gib\n")
        while True:
            rss = tree_rss(parent_pid)
            if rss is None:
                break
            max_rss = max(max_rss, rss)
            f.write(f"{time.monotonic() - t0:.2f},{rss / 2**30:.4f}\n")
            f.flush()
            with open(max_path, "wt", encoding="utf-8") as mf:
                mf.write(f"{max_rss / 2**30:.4f} GiB\n")
            time.sleep(interval_s)


def launch_monitor_rss_daemon(
    out_dir: Path | str, interval_s: float = 1.0
) -> mp.Process:
    r"""Start a daemon process sampling process-tree RSS into the run dir."""
    proc = mp.get_context("spawn").Process(
        target=_monitor_rss,
        args=(Path(out_dir), os.getpid(), interval_s),
        daemon=True,
    )
    proc.start()
    return proc
