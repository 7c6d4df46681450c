r"""How a wrapper under ``ops/`` binds its hand-written CUDA kernel: load,
check, launch and count, in one place.

Dispatch: a wrapper's public function sends tensors on the CPU to its plain
PyTorch version and tensors on a CUDA device to its kernel in ``csrc/``;
anything the kernel does not take raises.  There is no fallback from a
kernel to the plain version.

Each wrapper declares one :class:`Kernel` for its source.  It counts its
launches in module-level integers (``route.route_launches``,
``tile_search.row_launches``, ...) that it names with
:func:`count_launches` at import: a replayed CUDA graph launches without
Python, so ``engine/graphs.py`` advances each counter of :data:`counters`
at a replay by what its capture counted.
"""

from __future__ import annotations

import ctypes
import sys
import types
import typing as tp

import torch

from bblean_tpu_torch import _build

__all__ = ["Kernel", "count_launches", "counters", "sm_count"]

# C type of each letter of a symbol table's signatures
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "q": ctypes.c_longlong, "z": ctypes.c_size_t}

# Launch counters that a graph replay advances: (module, attribute)
counters: list[tuple[types.ModuleType, str]] = []
_sm_counts: dict[int, int] = {}


def count_launches(module: str, *names: str) -> None:
    r"""Name integer launch counters ``<module>.<name>`` (the module is
    imported, or being imported) that graph replays advance."""
    for name in names:
        entry = (sys.modules[module], name)
        if entry not in counters:
            counters.append(entry)


def sm_count(dev: torch.device) -> int:
    r"""Streaming multiprocessors of CUDA device ``dev``; read once a
    process."""
    if dev.index not in _sm_counts:
        _sm_counts[dev.index] = torch.cuda.get_device_properties(dev).multi_processor_count
    return _sm_counts[dev.index]


def _shape_text(shape: tuple) -> str:
    return "(" + ", ".join("*" if d is None else str(d) for d in shape) + ")"


class Kernel:
    r"""The kernels of one CUDA source.

    ``name`` is what messages call them; ``source`` the file under
    ``csrc/``; ``symbols`` maps each C function to (argument letters,
    return letter) of :data:`_CTYPES`, the launches' last argument being
    the stream; ``verify(lib)`` runs once after the load and raises where
    the source's constants disagree with the wrapper's; ``error_text(err)``
    gives the message of an error code of the source's own, None for a
    CUDA error.
    """

    def __init__(self, name: str, source: str, symbols: dict[str, tuple[str, str]],
                 verify: tp.Callable | None = None, error_text: tp.Callable | None = None) -> None:
        self.name, self.source, self.symbols = name, source, symbols
        self.verify, self.error_text = verify, error_text
        self._lib: ctypes.CDLL | None = None

    def lib(self) -> ctypes.CDLL:
        r"""The built and loaded library with its symbols declared; cached
        per process.  A failed build raises (``_build``)."""
        if self._lib is None:
            lib = _build.load_kernel_library(self.source)
            for symbol, (args, ret) in self.symbols.items():
                fn = getattr(lib, symbol)
                fn.argtypes = [_CTYPES[c] for c in args]
                fn.restype = _CTYPES[ret]
            if self.verify is not None:
                self.verify(lib)
            self._lib = lib
        return self._lib

    def check(self, named: dict[str, tuple]) -> torch.device:
        r"""Raise ``ValueError`` unless every tensor of ``named`` (name ->
        (tensor or None, dtype, shape); None skips the entry, a None in
        the shape takes any size) has its dtype and shape and is
        contiguous on the device of the first, a CUDA device; returns that
        device."""
        first, dev = None, None
        for name, (t, dtype, shape) in named.items():
            if t is None:
                continue
            if first is None:
                first, dev = name, t.device
            if t.dtype != dtype or t.dim() != len(shape) or any(
                d is not None and d != s for d, s in zip(shape, t.shape)
            ):
                raise ValueError(
                    f"{self.name} kernel: {name} must be {dtype} of shape "
                    f"{_shape_text(shape)}, got {t.dtype} of shape {tuple(t.shape)}"
                )
            if t.device.type != "cuda" or t.device != dev:
                raise ValueError(
                    f"{self.name} kernel needs every tensor on one CUDA device; "
                    f"{name} is on {t.device}, {first} on {dev}"
                )
            if not t.is_contiguous():
                raise ValueError(f"{self.name} kernel: {name} must be contiguous")
        return dev

    def launch(self, symbol: str, dev: torch.device, *args) -> None:
        r"""Call ``symbol`` with ``args`` (a tensor passes its address, None
        a null pointer) and the current stream of ``dev``, under ``dev``'s
        guard; raise ``RuntimeError`` on a nonzero return."""
        fn = getattr(self.lib(), symbol)
        ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
        with torch.cuda.device(dev):
            err = fn(*ptrs, torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            text = self.error_text(err) if self.error_text is not None else None
            raise RuntimeError(text or f"{self.name} kernel launch failed: CUDA error {err}")
