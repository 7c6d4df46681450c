r"""Host (NumPy) fingerprint helpers of the port.

Copies of ``bblean_tpu``'s host helpers, so that the port and its smoke run
need nothing of the JAX package: ``pack_fingerprints`` /
``unpack_fingerprints``, ``make_fake_fingerprints``, the ``.npy`` header
introspection (``_get_fps_file_num``, ``_print_fps_file_info``) and the
multi-file gather (``_FingerprintFileSequence``,
``_get_fingerprints_from_file_seq``) from ``bblean_tpu/fingerprints.py``.
They are the same code, so a seed gives the same fingerprints in both
packages.  The float64 ``jt_isim_from_sum`` is defined once, in
``_np_similarity.py``, and re-exported here.  The SMILES featurization
(RDKit) is not ported yet.
"""

from __future__ import annotations

import typing as tp
from pathlib import Path

import numpy as np
from numpy.typing import DTypeLike, NDArray

__all__ = [
    "make_fake_fingerprints",
    "pack_fingerprints",
    "unpack_fingerprints",
    "jt_isim_from_sum",
]


def pack_fingerprints(a: NDArray[np.uint8]) -> NDArray[np.uint8]:
    r"""Pack a binary (0/1-valued) uint8 fingerprint array along the last axis."""
    return np.packbits(a, axis=-1)


def unpack_fingerprints(
    a: NDArray[np.uint8], n_features: int | None = None
) -> NDArray[np.uint8]:
    r"""Unpack a packed uint8 array into 0/1-valued uint8 bits.

    ``n_features`` trims zero padding when the bit count is not a multiple of 8.
    """
    return np.unpackbits(a, axis=-1, count=n_features)


def make_fake_fingerprints(
    num: int,
    n_features: int = 2048,
    pack: bool = True,
    seed: int | None = None,
    dtype: DTypeLike = np.uint8,
) -> NDArray[np.uint8]:
    r"""Generate synthetic fingerprints with realistic popcount statistics.

    Popcounts are drawn from a truncated normal (loc=750, scale=400, clipped to
    (1, n_features-1)) and bits are permuted per row.  Bit-exact with the
    reference generator (``fingerprints.py:70-108``) for identical seeds, which
    anchors every golden clustering fixture.
    """
    import scipy.stats  # Deferred: scipy import is heavy

    if n_features < 1 or n_features % 8 != 0:
        raise ValueError("n_features must be a multiple of 8, and greater than 0")
    if pack and np.dtype(dtype) != np.dtype(np.uint8):
        raise ValueError("Only np.uint8 dtype is supported for packed input")

    loc, scale = 750, 400
    lo, hi = 1, n_features - 1
    rng = np.random.default_rng(seed)
    popcount_sample = scipy.stats.truncnorm.rvs(
        (lo - loc) / scale,
        (hi - loc) / scale,
        loc=loc,
        scale=scale,
        size=num,
        random_state=rng,
    )
    ones_per_row = np.rint(popcount_sample).astype(np.int64)
    # Build each row as [1]*ones + [0]*zeros, then shuffle within the row
    run_lengths = np.empty(num * 2, dtype=np.int64)
    run_lengths[0::2] = ones_per_row
    run_lengths[1::2] = n_features - ones_per_row
    bits = np.repeat(np.tile(np.array([1, 0], np.uint8), num), run_lengths)
    fps = rng.permuted(bits.reshape(num, n_features), axis=-1)
    if pack:
        return np.packbits(fps, axis=1)
    return fps.astype(dtype, copy=False)


def __getattr__(name: str) -> tp.Any:
    # ``jt_isim_from_sum`` lives in ``_np_similarity`` (which imports this
    # module); it stays importable from here, resolved at first access
    if name == "jt_isim_from_sum":
        from bblean_tpu_torch._np_similarity import jt_isim_from_sum

        return jt_isim_from_sum
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _read_npy_header(path: Path) -> tuple[tuple[int, ...], np.dtype]:
    with open(path, mode="rb") as f:
        major, minor = np.lib.format.read_magic(f)
        read_header = getattr(np.lib.format, f"read_array_header_{major}_{minor}")
        shape, _fortran, dtype = read_header(f)
    return shape, dtype


def _get_fps_file_num(path: Path) -> int:
    return _read_npy_header(path)[0][0]


def _get_fps_file_shape_and_dtype(
    path: Path, raise_if_invalid: bool = False
) -> tuple[tuple[int, int], np.dtype, bool, bool]:
    shape, dtype = _read_npy_header(path)
    shape_is_valid = len(shape) == 2
    dtype_is_valid = np.issubdtype(dtype, np.integer)
    if raise_if_invalid and (not shape_is_valid or not dtype_is_valid):
        raise ValueError(
            f"Fingerprints file {path} is invalid. Shape: {shape}, DType {dtype}"
        )
    return tp.cast(tp.Tuple[int, int], shape), dtype, shape_is_valid, dtype_is_valid


def _print_fps_file_info(path: Path, console: tp.Any = None) -> None:
    r"""Pretty-print shape/dtype/validity of a fingerprint ``.npy`` file."""
    if console is None:
        from bblean_tpu_torch._console import get_console

        console = get_console()
    shape, dtype, shape_ok, dtype_ok = _get_fps_file_shape_and_dtype(path)
    console.print(f"File: {path.resolve()}")
    if shape_ok and dtype_ok:
        console.print("    - [green]Valid fingerprint file[/green]")
    else:
        console.print("    - [red]Invalid fingerprint file[/red]")
    if shape_ok:
        console.print(f"    - Num. fingerprints: {shape[0]:,}")
        console.print(f"    - Num. features: {shape[1]:,}")
    else:
        console.print(f"    - Shape: {shape}")
    console.print(f"    - DType: [yellow]{dtype.name}[/yellow]")
    console.print()


class _FingerprintFileSequence:
    r"""Lazy view over a sequence of ``.npy`` fingerprint files as one array."""

    def __init__(self, files: tp.Iterable[Path]) -> None:
        self._files = list(files)
        if not self._files:
            raise ValueError("At least 1 fingerprint file must be provided")

    def __getitem__(self, idxs: tp.Sequence[int]) -> NDArray[np.uint8]:
        return _get_fingerprints_from_file_seq(self._files, idxs)

    @property
    def shape(self) -> tuple[int, int]:
        shape, _, _, _ = _get_fps_file_shape_and_dtype(
            self._files[0], raise_if_invalid=True
        )
        return shape


def _get_fingerprints_from_file_seq(
    files: tp.Iterable[Path], idxs: tp.Sequence[int]
) -> NDArray[np.uint8]:
    r"""Gather globally-indexed rows spread over consecutive ``.npy`` files.

    ``idxs`` must be sorted ascending; files are treated as one concatenated
    array in order.
    """
    if sorted(idxs) != list(idxs):
        raise ValueError("idxs must be sorted")
    files = list(files)
    idx_arr = np.asarray(idxs, dtype=np.int64)

    n_features: int | None = None
    per_file_local: list[NDArray[np.int64]] = []
    offset = 0
    for f in files:
        (num, feats), _, _, _ = _get_fps_file_shape_and_dtype(f, raise_if_invalid=True)
        in_file = idx_arr[(idx_arr >= offset) & (idx_arr < offset + num)]
        per_file_local.append(in_file - offset)
        offset += num
        if n_features is None:
            n_features = feats
        elif feats != n_features:
            raise ValueError(
                f"Incompatible fingerprint file {f},"
                f" expected {n_features} features, found {feats}"
            )
    total = int(sum(a.size for a in per_file_local))
    if total != len(idx_arr):
        raise ValueError("idxs could not be extracted from files")

    out = np.empty((len(idx_arr), tp.cast(int, n_features)), dtype=np.uint8)
    row = 0
    for f, local in zip(files, per_file_local):
        if not local.size:
            continue
        out[row : row + local.size] = np.load(f, mmap_mode="r")[local].astype(
            np.uint8, copy=False
        )
        row += local.size
    return out
