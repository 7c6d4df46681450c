r"""Build the package's C++ and CUDA sources at first use and load them.

Each CUDA source under ``csrc/`` is compiled into a shared library with a
plain C interface (``nvcc -gencode arch=compute_90a,code=sm_90a -O3
-std=c++17 -shared -Xcompiler -fPIC``) and loaded with ``ctypes``.  A missing
``nvcc`` or a failed build raises: there is no fallback.

The host library (``csrc/bblean_native.cpp``, the native exact engine) is
built the same way with ``$CXX``, else ``g++``, else ``c++`` (``-O3 -std=c++17 -fPIC -shared
-march=x86-64-v2 -funroll-loops``).  It is optional: a machine without a C++
compiler gets :class:`CompilerNotFound` (an ``ImportError``), which callers
turn into the Python engine.  A compiler that is there and fails raises
``RuntimeError`` with its output, like ``nvcc``.

A library's file name carries a hash of its source and flags, so an edited
source is rebuilt and a built one is reused; it is written under a temporary
name and renamed, so concurrent builds do not see a partial file.  Nothing
is built when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

__all__ = [
    "load_kernel_library",
    "host_library_path",
    "build_host_library",
    "build_seconds",
    "CompilerNotFound",
]

_CSRC = Path(__file__).parent / "csrc"
_BUILD_DIR = _CSRC / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
]

# Portable baseline (any 2009+ x86-64); the source picks its AVX-512 popcount
# paths at run time through per-function target attributes
CXX_FLAGS = [
    "-O3", "-std=c++17", "-fPIC", "-shared", "-march=x86-64-v2", "-funroll-loops",
]

_loaded: dict[str, ctypes.CDLL] = {}
# Wall seconds each library took to build in this process (0.0 = reused)
build_seconds: dict[str, float] = {}


def _find_nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            cands.append(os.path.join(os.environ[env], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda/bin): the CUDA "
        "kernels of bblean_tpu_torch cannot be built"
    )


class CompilerNotFound(ImportError):
    r"""No host C++ compiler on this machine (``$CXX``, ``g++``, ``c++``)."""


def _find_cxx() -> str:
    names = [n for n in (os.environ.get("CXX"), "g++", "c++") if n]
    for name in names:
        path = shutil.which(name)
        if path is not None:
            return path
    raise CompilerNotFound(
        f"no C++ compiler found (tried {', '.join(names)}): the native host "
        "library of bblean_tpu_torch cannot be built"
    )


def _library_path(source: str, flags: list[str]) -> Path:
    src = _CSRC / source
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(flags).encode()
    ).hexdigest()[:16]
    return _BUILD_DIR / f"{src.stem}_{digest}.so"


def _build(source: str, flags: list[str], find_compiler) -> Path:
    r"""Path of the library built from ``csrc/<source>`` with ``flags``,
    compiling it first when it is not there."""
    src = _CSRC / source
    lib_path = _library_path(source, flags)
    build_seconds[source] = 0.0
    if lib_path.exists():
        return lib_path
    compiler = find_compiler()
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [compiler, *flags, "-o", tmp, str(src)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"{Path(compiler).name} failed to build {src.name} "
                f"(exit {proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
            )
        if not lib_path.exists():  # else a concurrent build got there first
            os.replace(tmp, lib_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    build_seconds[source] = time.perf_counter() - t0
    return lib_path


def load_kernel_library(source: str) -> ctypes.CDLL:
    r"""Build (if needed) and load ``csrc/<source>``; cached per process."""
    if source in _loaded:
        return _loaded[source]
    lib = ctypes.CDLL(os.fspath(_build(source, NVCC_FLAGS, _find_nvcc)))
    _loaded[source] = lib
    return lib


def host_library_path(source: str) -> Path | None:
    r"""Where the host library of ``csrc/<source>`` is, or None when it has
    not been built (nothing is built here)."""
    path = _library_path(source, CXX_FLAGS)
    return path if path.exists() else None


def build_host_library(source: str) -> Path:
    r"""Build (if needed) ``csrc/<source>`` with the host C++ compiler and
    return the library's path.  Raises :class:`CompilerNotFound` where there
    is no compiler and ``RuntimeError`` where the compiler fails."""
    return _build(source, CXX_FLAGS, _find_cxx)
