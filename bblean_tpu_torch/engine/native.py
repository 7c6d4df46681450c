r"""Native (C++) exact-tree engine wrapper.

Implements the same engine interface as ``bblean_tpu_torch.engine.exact.ExactTree``
— bit-identical clustering decisions — with the entire insert loop running in
``libbblean_native.so`` (see ``bblean_tpu_torch/csrc/bblean_native.cpp``).  The
reference keeps this loop in Python with C++ kernels
(``bblean/bitbirch.py:305-357``); moving the loop itself native removes the
per-row interpreter overhead.

Inserts are batched: the ``BitBirch`` front-end hands whole packed chunks /
buffer groups to the library in one ``ctypes`` call.  Leaf state is pulled
back lazily (cached, invalidated on insert).

Adaptive-tolerance criteria receive a LUT of ``np.exp`` values so the C++
side cannot diverge from NumPy's exp by a ULP.
"""

from __future__ import annotations

import ctypes
import typing as tp

import numpy as np
from numpy.typing import NDArray

from bblean_tpu_torch import _native
from bblean_tpu_torch.utils import min_safe_uint

__all__ = ["NativeExactTree", "native_engine_available"]

_CRITERION_IDS = {
    "radius": 0,
    "diameter": 1,
    "tolerance-diameter": 2,
    "tolerance-radius": 3,
    "tolerance-legacy": 4,
    "never-merge": 5,
}

_CODE_TO_DTYPE = {1: "uint8", 2: "uint16", 4: "uint32", 8: "uint64"}

_N_MAX = 1000
_DECAY = 1e-3


def native_engine_available() -> bool:
    return _native.available()


def _tree_bindings(lib: ctypes.CDLL) -> ctypes.CDLL:
    if getattr(lib, "_bb_tree_configured", False):
        return lib
    i64 = ctypes.c_int64
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    i64p = ctypes.POINTER(i64)
    f64p = ctypes.POINTER(ctypes.c_double)
    vp = ctypes.c_void_p

    lib.bb_tree_new.restype = vp
    lib.bb_tree_new.argtypes = [i64, i64, ctypes.c_int, ctypes.c_double,
                                ctypes.c_double, f64p, i64]
    lib.bb_tree_free.argtypes = [vp]
    lib.bb_tree_set_params.argtypes = [vp, ctypes.c_int, ctypes.c_double,
                                       ctypes.c_double]
    lib.bb_tree_insert_packed.argtypes = [vp, u8p, i64, i64, i64p]
    lib.bb_tree_insert_buffers.argtypes = [vp, u64p, i64p, i64, i64p, i64p,
                                           ctypes.c_int]
    lib.bb_tree_num_leaf_subs.restype = i64
    lib.bb_tree_num_leaf_subs.argtypes = [vp]
    lib.bb_tree_leaf_meta.argtypes = [vp, i64p, i64p, u8p, u8p]
    lib.bb_tree_leaf_mols.argtypes = [vp, i64p]
    lib.bb_tree_leaf_centroids.argtypes = [vp, u8p]
    lib.bb_tree_leaf_ls.argtypes = [vp, u64p]
    lib.bb_tree_root_is_leaf.restype = ctypes.c_int
    lib.bb_tree_root_is_leaf.argtypes = [vp]
    lib.bb_tree_serialized_size.restype = i64
    lib.bb_tree_serialized_size.argtypes = [vp]
    lib.bb_tree_serialize.argtypes = [vp, u8p]
    lib.bb_tree_deserialize.restype = vp
    lib.bb_tree_deserialize.argtypes = [u8p]
    lib._bb_tree_configured = True
    return lib


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _tolerance_lut() -> NDArray[np.float64]:
    r"""max(np.exp(-decay*n) - np.exp(-decay*n_max), 0) for n in [0, n_max].

    Tolerance-free: the C++ side multiplies by the live tolerance.  Using
    NumPy's exp here keeps adaptive-tolerance decisions bit-identical to the
    Python engines.
    """
    n = np.arange(_N_MAX + 1, dtype=np.float64)
    offset = np.exp(-_DECAY * _N_MAX)
    return np.maximum(np.exp(-_DECAY * n) - offset, 0.0)


class NativeExactTree:
    r"""ctypes front-end to the native exact-tree engine."""

    def __init__(self, branching_factor: int, n_features: int) -> None:
        self.branching_factor = branching_factor
        self.n_features = n_features
        self.n_bytes = (n_features + 7) // 8
        self._lib = _tree_bindings(_native._load())
        self._handle: ctypes.c_void_p | None = None
        self._dropped = False
        self._cache: dict[str, tp.Any] | None = None
        self._criterion_params: tuple[str, float, float] | None = None

    def __del__(self) -> None:  # pragma: no cover - GC timing
        if getattr(self, "_handle", None):
            self._lib.bb_tree_free(self._handle)
            self._handle = None

    # -- pickling: whole-tree binary serialization through the library -----

    def __getstate__(self) -> dict[str, tp.Any]:
        state = {
            "branching_factor": self.branching_factor,
            "n_features": self.n_features,
            "_dropped": self._dropped,
            "_criterion_params": self._criterion_params,
            "blob": None,
        }
        if self._handle is not None:
            size = int(self._lib.bb_tree_serialized_size(self._handle))
            blob = np.empty(size, dtype=np.uint8)
            self._lib.bb_tree_serialize(
                self._handle, _ptr(blob, ctypes.c_uint8)
            )
            state["blob"] = blob.tobytes()
        return state

    def __setstate__(self, state: dict[str, tp.Any]) -> None:
        self.branching_factor = state["branching_factor"]
        self.n_features = state["n_features"]
        self.n_bytes = (self.n_features + 7) // 8
        self._lib = _tree_bindings(_native._load())
        self._dropped = state["_dropped"]
        self._criterion_params = state["_criterion_params"]
        self._cache = None
        self._handle = None
        if state["blob"] is not None:
            blob = np.frombuffer(state["blob"], dtype=np.uint8)
            self._handle = self._lib.bb_tree_deserialize(
                _ptr(blob, ctypes.c_uint8)
            )

    # -- lifecycle -------------------------------------------------------

    def init_root(self) -> None:
        lut = _tolerance_lut()
        self._handle = self._lib.bb_tree_new(
            self.n_features, self.branching_factor, 1, 0.65, 0.05,
            _ptr(lut, ctypes.c_double), len(lut),
        )

    @property
    def is_init(self) -> bool:
        return self._handle is not None

    @property
    def root_is_leaf(self) -> bool:
        return bool(self._lib.bb_tree_root_is_leaf(self._handle))

    def drop_internal_nodes(self) -> None:
        # The native tree is compact; mark reads-only like the array engine
        if not self.root_is_leaf:
            self._dropped = True

    def set_criterion(
        self, criterion: str, threshold: float, tolerance: float
    ) -> None:
        if criterion not in _CRITERION_IDS:
            raise ValueError(f"Native engine does not support {criterion!r}")
        params = (criterion, float(threshold), float(tolerance))
        if params != self._criterion_params:
            self._lib.bb_tree_set_params(
                self._handle, _CRITERION_IDS[criterion], threshold, tolerance
            )
            self._criterion_params = params

    # -- batched insertion -------------------------------------------------

    def insert_packed_chunk(
        self, packed: NDArray[np.uint8], mol_idxs: NDArray[np.int64]
    ) -> None:
        packed = np.ascontiguousarray(packed, dtype=np.uint8)
        mol_idxs = np.ascontiguousarray(mol_idxs, dtype=np.int64)
        self._lib.bb_tree_insert_packed(
            self._handle,
            _ptr(packed, ctypes.c_uint8),
            packed.shape[0],
            packed.shape[1],
            _ptr(mol_idxs, ctypes.c_int64),
        )
        self._cache = None

    def insert_buffer_group(
        self,
        buffers: tp.Sequence[NDArray[np.integer]],
        mol_lists: tp.Sequence[tp.Sequence[int]],
        dtype_code: int,
        chunk: int = 8192,
    ) -> None:
        for start in range(0, len(buffers), chunk):
            stop = min(start + chunk, len(buffers))
            group = buffers[start:stop]
            mols = mol_lists[start:stop]
            rows = np.ascontiguousarray(
                np.stack([np.asarray(b[:-1]) for b in group]),
                dtype=np.uint64,
            )
            ns = np.ascontiguousarray(
                [int(b[-1]) for b in group], dtype=np.int64
            )
            offsets = np.zeros(len(mols) + 1, dtype=np.int64)
            offsets[1:] = np.cumsum([len(m) for m in mols])
            flat = np.ascontiguousarray(
                [i for m in mols for i in m], dtype=np.int64
            )
            if flat.size == 0:
                flat = np.zeros(1, dtype=np.int64)  # valid ctypes pointer
            self._lib.bb_tree_insert_buffers(
                self._handle,
                _ptr(rows, ctypes.c_uint64),
                _ptr(ns, ctypes.c_int64),
                rows.shape[0],
                _ptr(flat, ctypes.c_int64),
                _ptr(offsets, ctypes.c_int64),
                dtype_code,
            )
        self._cache = None

    # -- extraction (lazy, cached) -----------------------------------------

    def _leaves(self) -> dict[str, tp.Any]:
        if self._cache is not None:
            return self._cache
        num = int(self._lib.bb_tree_num_leaf_subs(self._handle))
        ns = np.empty(num, dtype=np.int64)
        mol_counts = np.empty(num, dtype=np.int64)
        mutated = np.empty(num, dtype=np.uint8)
        codes = np.empty(num, dtype=np.uint8)
        self._lib.bb_tree_leaf_meta(
            self._handle, _ptr(ns, ctypes.c_int64),
            _ptr(mol_counts, ctypes.c_int64), _ptr(mutated, ctypes.c_uint8),
            _ptr(codes, ctypes.c_uint8),
        )
        flat = np.empty(int(mol_counts.sum()), dtype=np.int64)
        if flat.size:
            self._lib.bb_tree_leaf_mols(self._handle, _ptr(flat, ctypes.c_int64))
        cents = np.empty((num, self.n_bytes), dtype=np.uint8)
        if num:
            self._lib.bb_tree_leaf_centroids(
                self._handle, _ptr(cents, ctypes.c_uint8)
            )
        offsets = np.zeros(num + 1, dtype=np.int64)
        offsets[1:] = np.cumsum(mol_counts)
        self._cache = {
            "ns": ns,
            "mutated": mutated,
            "codes": codes,
            "cents": cents,
            "mols_flat": flat,
            "offsets": offsets,
            "ls": None,
        }
        return self._cache

    def _leaf_ls(self) -> NDArray[np.uint64]:
        cache = self._leaves()
        if cache["ls"] is None:
            num = len(cache["ns"])
            ls = np.empty((num, self.n_features), dtype=np.uint64)
            if num:
                self._lib.bb_tree_leaf_ls(self._handle, _ptr(ls, ctypes.c_uint64))
            cache["ls"] = ls
        return cache["ls"]

    def iter_leaves(self) -> tp.Iterator[int]:  # interface parity
        yield from range(len(self._leaves()["ns"]))

    def leaf_sub_ids(self, sort: bool = True) -> list[int]:
        ns = self._leaves()["ns"]
        ids = list(range(len(ns)))
        if sort:
            ids.sort(key=lambda i: ns[i], reverse=True)
        return ids

    def sub_n(self, sid: int) -> int:
        return int(self._leaves()["ns"][sid])

    def sub_mols(self, sid: int) -> list[int]:
        cache = self._leaves()
        lo, hi = cache["offsets"][sid], cache["offsets"][sid + 1]
        return cache["mols_flat"][lo:hi].tolist()

    def sub_packed_centroid(self, sid: int) -> NDArray[np.uint8]:
        return self._leaves()["cents"][sid]

    def sub_dtype_name(self, sid: int) -> str:
        cache = self._leaves()
        if cache["mutated"][sid]:
            return min_safe_uint(int(cache["ns"][sid])).name
        return _CODE_TO_DTYPE[int(cache["codes"][sid])]

    def sub_buffer(self, sid: int) -> NDArray[np.integer]:
        cache = self._leaves()
        dtype = np.dtype(self.sub_dtype_name(sid))
        buf = np.empty(self.n_features + 1, dtype=dtype)
        buf[:-1] = self._leaf_ls()[sid]
        buf[-1] = cache["ns"][sid]
        return buf
