r"""The insert round's merge tests: the moments of a segmented prefix commit,
with a CUDA kernel on the card and the plain PyTorch version.

Counterpart of the lines of ``bblean_tpu/engine/batch.py:406-470`` that JAX
fuses inside its jitted step: the exclusive scan of the accepted rows' sums
along the sorted rows (``jnp.cumsum(s_ls, axis=0)``, ``:415`` and ``:448``),
restarted at each candidate's segment, and the iSIM sums that
``merge_accept_batch`` reads of the merged and pre-merge clusters.  The
batch engine calls :func:`prefix_commit_moments` three times a round: the
individual screen (no order, no mask, every row its own segment), pass 1
and pass 2 of the prefix commits; ``ops/merges.py::merge_accept_from_moments``
turns the moments into the accept mask.  Each call passes ``need``, the
rows whose result the round keeps (the screen's candidates, each pass's
mask), so the kernel reads nothing for the others.

Contract.  For sorted row ``i``, ``r = order[i]`` (``i`` when ``order`` is
None), ``s[i] = mask[i] ? row_ls[r] : 0`` (``row_ls[r]`` when ``mask`` is
None), ``pre[i]`` the sum of ``s`` over the earlier rows of ``i``'s segment
(a segment starts at ``i`` where ``seg_start[i] == i``; every row starts one
when ``seg_start`` is None), ``y = cand_ls[r] + pre[i]`` and ``x = y + s[i]``
in int32 (wrapping as torch's int32 arithmetic does).  The result is
``ops/merges.py::merge_moments(criterion, x, new_n, y, old_n)``: per row the
int64 ``K = sum(x)``, ``Ksq = sum(x^2)``, for the radius criteria also the
sums of ``x + c`` and its squares (``c`` the f32 majority vote of
``ops/isim.py::majority_centroid_from_sums`` at ``new_n``), and for the
tolerance criteria the same of ``y`` (vote at ``old_n.clamp_min(2)``);
shape (moments, M), in sorted order.  A row outside ``need`` (a (M,) bool
in sorted order; None: every row) gets zeros.  Integer sums are exact in
any order, so the kernel's moments equal the plain version's bit for bit.

Dispatch: tensors on the CPU go to :func:`prefix_commit_moments_plain`
(today's torch code: the gathers, the masks, ``torch.cumsum``, the int64
sums); tensors on a CUDA device go to the hand-written kernel of
``csrc/prefix_commit.cu`` and anything it does not take raises.  There is
no fallback from the kernel to the plain version.  ``launches`` counts the
wrapper's calls that launched the kernel: one launch a call, whose blocks
take (chunk of sorted rows, column tile) items in order, carry the prefix
across chunks by a decoupled look-back and stage each row slice they read
in shared memory once.
"""

from __future__ import annotations

import ctypes

import torch

from bblean_tpu_torch.ops.merges import _radius, _reads_old, merge_moments, moment_count

__all__ = [
    "prefix_commit_moments",
    "prefix_commit_moments_plain",
    "launches",
]

_I32 = torch.int32
_SOURCE = "prefix_commit.cu"

# Calls of prefix_commit_moments that launched the kernel
launches = 0

_kernel_lib: ctypes.CDLL | None = None
_sm_count: dict[int, int] = {}


def _lib() -> ctypes.CDLL:
    global _kernel_lib
    if _kernel_lib is None:
        from bblean_tpu_torch._build import load_kernel_library

        lib = load_kernel_library(_SOURCE)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.bb_prefix_commit.argtypes = [p] * 10 + [i] * 6 + [p]
        lib.bb_prefix_commit.restype = i
        _kernel_lib = lib
    return _kernel_lib


def prefix_commit_moments_plain(
    criterion: str,
    row_ls: torch.Tensor,  # (M, F) int32, row order
    cand_ls: torch.Tensor,  # (M, F) int32, row order
    new_n: torch.Tensor,  # (M,) int32, sorted order
    old_n: torch.Tensor,  # (M,) int32, sorted order
    order: torch.Tensor | None = None,  # (M,) int64 sorted -> row
    mask: torch.Tensor | None = None,  # (M,) bool, sorted order
    seg_start: torch.Tensor | None = None,  # (M,) int64 segment start per sorted row
    need: torch.Tensor | None = None,  # (M,) bool, sorted order
) -> torch.Tensor:
    r"""The moments of the module's contract with torch ops."""
    if order is not None:
        row_ls, cand_ls = row_ls[order], cand_ls[order]
    s_ls = row_ls if mask is None else torch.where(mask[:, None], row_ls, 0)
    old_ls = cand_ls
    if seg_start is not None:
        excl = torch.cumsum(s_ls, dim=0, dtype=_I32) - s_ls
        old_ls = cand_ls + (excl - excl[seg_start])
    moments = merge_moments(criterion, old_ls + s_ls, new_n, old_ls, old_n)
    return moments if need is None else torch.where(need, moments, 0)


_TILE_COLS = 256  # columns of an item (csrc/prefix_commit.cu: kTileCols)
_MAX_CHUNK_ROWS = 16
_ITEMS_PER_SM = 4


def _chunk_rows(m: int, f: int, n_sm: int) -> int:
    r"""Sorted rows a chunk: at most 16 (a block's ring of two (chunk,
    column tile) items then takes 64 KiB of shared memory, three blocks an
    SM), fewer where the items would not give every SM four: 16 rows at
    M = 8192 and at M = 2048 (4,096 and 1,024 items at F = 2048 on 132
    SMs)."""
    tiles = -(-f // _TILE_COLS)
    return min(_MAX_CHUNK_ROWS, max(1, m * tiles // (_ITEMS_PER_SM * n_sm)))


def _check(named: dict) -> None:
    r"""Raise unless every given tensor is on one CUDA device, contiguous,
    of its dtype and shape (``named``: name -> (tensor or None, dtype,
    shape))."""
    dev = named["row_ls"][0].device
    for name, (t, dtype, shape) in named.items():
        if t is None:
            continue
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(
                f"prefix-commit kernel needs every tensor on one CUDA device; "
                f"{name} is on {t.device}, row_ls on {dev}"
            )
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"prefix-commit kernel: {name} must be {dtype} of shape {shape}, "
                f"got {t.dtype} of shape {tuple(t.shape)}"
            )
        if not t.is_contiguous():
            raise ValueError(f"prefix-commit kernel: {name} must be contiguous")


def _launch(
    criterion, row_ls, cand_ls, new_n, old_n, order, mask, seg_start, need=None,
) -> torch.Tensor:
    global launches
    if row_ls.dim() != 2:
        raise ValueError(f"prefix-commit kernel: row_ls must be 2-d, got {row_ls.dim()}-d")
    m, f = row_ls.shape
    _check(
        {
            "row_ls": (row_ls, _I32, (m, f)),
            "cand_ls": (cand_ls, _I32, (m, f)),
            "new_n": (new_n, _I32, (m,)),
            "old_n": (old_n, _I32, (m,)),
            "order": (order, torch.int64, (m,)),
            "mask": (mask, torch.bool, (m,)),
            "seg_start": (seg_start, torch.int64, (m,)),
            "need": (need, torch.bool, (m,)),
        },
    )
    n_mom = moment_count(criterion)
    dev = row_ls.device
    if n_mom == 0 or m == 0 or f == 0:  # nothing to sum: no launch
        return torch.zeros((n_mom, m), dtype=torch.int64, device=dev)
    bulk = f % 4 == 0 and row_ls.data_ptr() % 16 == 0 and cand_ls.data_ptr() % 16 == 0
    lib = _lib()
    with torch.cuda.device(dev):
        idx = dev.index if dev.index is not None else torch.cuda.current_device()
        if idx not in _sm_count:
            _sm_count[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
        rows = _chunk_rows(m, f, _sm_count[idx])
        chunks = -(-m // rows)
        # Zeros: rows outside need stay so, and where F spans several column
        # tiles the tiles add into it
        out = torch.zeros((n_mom, m), dtype=torch.int64, device=dev)
        # With segments: the ticket, then each chunk's flagged tail or
        # prefix a column (the look-back's words), zeroed
        status = None
        if seg_start is not None:
            status = torch.zeros((1 + chunks * f,), dtype=torch.int64, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        ptrs = [
            None if t is None else t.data_ptr()
            for t in (order, mask, seg_start, need, status)
        ]
        err = lib.bb_prefix_commit(
            row_ls.data_ptr(), cand_ls.data_ptr(), *ptrs[:4], new_n.data_ptr(),
            old_n.data_ptr(), *ptrs[4:], out.data_ptr(),
            m, f, rows, int(_radius(criterion)), int(_reads_old(criterion)), int(bulk), stream,
        )
    if err != 0:
        raise RuntimeError(f"prefix-commit kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def prefix_commit_moments(
    criterion: str,
    row_ls: torch.Tensor,  # (M, F) int32, row order
    cand_ls: torch.Tensor,  # (M, F) int32, row order
    new_n: torch.Tensor,  # (M,) int32, sorted order
    old_n: torch.Tensor,  # (M,) int32, sorted order
    order: torch.Tensor | None = None,  # (M,) int64 sorted -> row
    mask: torch.Tensor | None = None,  # (M,) bool, sorted order
    seg_start: torch.Tensor | None = None,  # (M,) int64 segment start per sorted row
    need: torch.Tensor | None = None,  # (M,) bool, sorted order
) -> torch.Tensor:
    r"""(moments, M) int64 moments of the merge tests of a segmented prefix
    commit (the module's contract), in sorted order; zeros outside
    ``need``.

    Replaces ``bblean_tpu/engine/batch.py:390`` and ``:406-470`` (the
    scans and the sums inside ``merge_accept_batch``).  On the card one
    call of ``bb_prefix_commit`` (``csrc/prefix_commit.cu``); on the CPU
    :func:`prefix_commit_moments_plain`.
    """
    args = (criterion, row_ls, cand_ls, new_n, old_n, order, mask, seg_start, need)
    if row_ls.device.type == "cpu":
        return prefix_commit_moments_plain(*args)
    return _launch(*args)
