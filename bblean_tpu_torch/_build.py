r"""Build the package's CUDA kernels with ``nvcc`` at first use and load them.

Each source under ``csrc/`` is compiled into a shared library with a plain C
interface (``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17
-shared -Xcompiler -fPIC``) and loaded with ``ctypes``.  The library's file
name carries a hash of the source, so an edited source is rebuilt and a
built one is reused.  A missing ``nvcc`` or a failed build raises: there is
no fallback.  Nothing is built when this module is imported.
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

__all__ = ["load_kernel_library", "build_seconds"]

_CSRC = Path(__file__).parent / "csrc"
_BUILD_DIR = _CSRC / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
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


def load_kernel_library(source: str) -> ctypes.CDLL:
    r"""Build (if needed) and load ``csrc/<source>``; cached per process."""
    if source in _loaded:
        return _loaded[source]
    src = _CSRC / source
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    lib_path = _BUILD_DIR / f"{src.stem}_{digest}.so"
    build_seconds[source] = 0.0
    if not lib_path.exists():
        nvcc = _find_nvcc()
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(
                [nvcc, *NVCC_FLAGS, "-o", tmp, str(src)],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed to build {src.name} "
                    f"(exit {proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
                )
            os.replace(tmp, lib_path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        build_seconds[source] = time.perf_counter() - t0
    lib = ctypes.CDLL(os.fspath(lib_path))
    _loaded[source] = lib
    return lib
