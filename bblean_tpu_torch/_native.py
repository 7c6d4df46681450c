r"""Loader for the native (C++) host library.

The native library is built from ``bblean_tpu_torch/csrc/bblean_native.cpp``
at first use (``_build.build_host_library``: ``$CXX`` or ``g++``, into
``csrc/build/`` under a name that carries a hash of source and flags).  It
provides:

- SIMD popcount / Tanimoto / iSIM kernels for the host path (the device path
  uses ``bblean_tpu_torch.ops`` instead), and
- a full native implementation of the exact serial-equivalent BitBirch insert
  loop (``bb_exact_fit``), which the reference keeps in Python
  (reference hot loop: ``bblean/bitbirch.py:305-357``).

Bindings use ``ctypes`` (no pybind11 dependency).  The library is optional:
on a machine without a C++ compiler :func:`available` is False and the
facade in ``bblean_tpu_torch.similarity`` and ``BitBirch`` use NumPy and the
Python engine, with the same results.  A compiler that is there and fails to
build the source is a fault, not a missing option: its ``RuntimeError``,
with the compiler's output, goes through :func:`available` to the caller.
"""

from __future__ import annotations

import ctypes
import os
from pathlib import Path

import numpy as np
from numpy.typing import NDArray

from bblean_tpu_torch import _build

_SOURCE = "bblean_native.cpp"

_lib: ctypes.CDLL | None = None
_lib_path: Path | None = None
_failure: Exception | None = None


def native_lib_path() -> Path | None:
    r"""Path of the built native library, or None when not built."""
    return _build.host_library_path(_SOURCE)


def loaded_lib_path() -> Path | None:
    r"""Path of the library this process has loaded, or None."""
    return _lib_path


def _load() -> ctypes.CDLL:
    global _lib, _lib_path, _failure
    if _lib is not None:
        return _lib
    if _failure is not None:
        raise _failure
    try:
        path = _build.build_host_library(_SOURCE)
        lib = ctypes.CDLL(os.fspath(path))
    except (ImportError, OSError, RuntimeError) as err:
        _failure = err
        raise
    _configure(lib)
    _lib, _lib_path = lib, path
    return lib


def _configure(lib: ctypes.CDLL) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    f64p = ctypes.POINTER(ctypes.c_double)
    i64 = ctypes.c_int64

    lib.bb_jt_isim_from_sum_u64.restype = ctypes.c_double
    lib.bb_jt_isim_from_sum_u64.argtypes = [u64p, i64, i64]

    lib.bb_jt_sim_arr_vec_packed.restype = None
    lib.bb_jt_sim_arr_vec_packed.argtypes = [u8p, u8p, i64, i64, f64p]

    lib.bb_most_dissimilar_packed.restype = None
    lib.bb_most_dissimilar_packed.argtypes = [
        u8p, i64, i64, i64,
        ctypes.POINTER(i64), ctypes.POINTER(i64), f64p, f64p,
    ]


def _as_c(arr: np.ndarray, ctype: type) -> ctypes._Pointer:
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def jt_isim_from_sum(linear_sum: NDArray[np.integer], n_objects: int) -> float:
    r"""Native iSIM from a linear sum (see ``_np_similarity.jt_isim_from_sum``)."""
    lib = _load()
    if n_objects < 2:
        import warnings

        warnings.warn(
            f"Invalid n_objects = {n_objects} in isim. Expected n_objects >= 2",
            RuntimeWarning,
            stacklevel=2,
        )
        return np.nan
    x = np.ascontiguousarray(linear_sum, dtype=np.uint64)
    return lib.bb_jt_isim_from_sum_u64(_as_c(x, ctypes.c_uint64), len(x), n_objects)


def _jt_sim_arr_vec_packed(
    x: NDArray[np.uint8], y: NDArray[np.uint8]
) -> NDArray[np.float64]:
    r"""Native packed Tanimoto of array rows vs one vector."""
    lib = _load()
    if x.ndim != 2 or y.ndim != 1:
        raise ValueError("Expected a 2D array and a 1D vector as inputs")
    x = np.ascontiguousarray(x, dtype=np.uint8)
    y = np.ascontiguousarray(y, dtype=np.uint8)
    out = np.empty(len(x), dtype=np.float64)
    lib.bb_jt_sim_arr_vec_packed(
        _as_c(x, ctypes.c_uint8),
        _as_c(y, ctypes.c_uint8),
        x.shape[0],
        x.shape[1],
        _as_c(out, ctypes.c_double),
    )
    return out


def jt_most_dissimilar_packed(
    Y: NDArray[np.uint8], n_features: int | None = None
) -> tuple[np.integer, np.integer, NDArray[np.float64], NDArray[np.float64]]:
    r"""Native O(N) most-dissimilar pair heuristic (packed input)."""
    lib = _load()
    Y = np.ascontiguousarray(Y, dtype=np.uint8)
    n, b = Y.shape
    nf = n_features if n_features is not None else b * 8
    i1 = ctypes.c_int64()
    i2 = ctypes.c_int64()
    sims1 = np.empty(n, dtype=np.float64)
    sims2 = np.empty(n, dtype=np.float64)
    lib.bb_most_dissimilar_packed(
        _as_c(Y, ctypes.c_uint8), n, b, nf,
        ctypes.byref(i1), ctypes.byref(i2),
        _as_c(sims1, ctypes.c_double), _as_c(sims2, ctypes.c_double),
    )
    return np.int64(i1.value), np.int64(i2.value), sims1, sims2


def jt_isim_unpacked(arr: NDArray[np.integer]) -> float:
    r"""iSIM of unpacked fps (native reduction of the linear sum)."""
    return jt_isim_from_sum(np.sum(arr, axis=0, dtype=np.uint64), len(arr))


def jt_isim_packed(fps: NDArray[np.integer], n_features: int | None = None) -> float:
    r"""iSIM of packed fps (native reduction of the linear sum)."""
    from bblean_tpu_torch.fingerprints import unpack_fingerprints

    return jt_isim_from_sum(
        np.sum(unpack_fingerprints(fps, n_features), axis=0, dtype=np.uint64),
        len(fps),
    )


def available() -> bool:
    r"""Whether the native library can be built and loaded on this host
    (no compiler: False; a compiler that fails: raises)."""
    try:
        _load()
        return True
    except (ImportError, OSError):
        return False
