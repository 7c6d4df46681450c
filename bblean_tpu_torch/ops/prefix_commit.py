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

``launches`` counts the calls that launched the kernel of
``csrc/prefix_commit.cu`` (``ops/_kernel.py``: how a wrapper dispatches):
one launch a call, whose blocks take (chunk of sorted rows, column tile)
items in order, carry the prefix across chunks by a decoupled look-back
and stage each row slice they read in shared memory once.
"""

from __future__ import annotations

import torch

from bblean_tpu_torch.ops import _kernel
from bblean_tpu_torch.ops.merges import _radius, _reads_old, merge_moments, moment_count

__all__ = [
    "prefix_commit_moments",
    "prefix_commit_moments_plain",
    "launches",
]

_I32 = torch.int32

# Calls of prefix_commit_moments that launched the kernel
launches = 0
_kernel.count_launches(__name__, "launches")

kernel = _kernel.Kernel(
    "prefix-commit", "prefix_commit.cu", {"bb_prefix_commit": ("p" * 10 + "i" * 6 + "p", "i")}
)


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


def _launch(
    criterion, row_ls, cand_ls, new_n, old_n, order, mask, seg_start, need=None,
) -> torch.Tensor:
    global launches
    if row_ls.dim() != 2:
        raise ValueError(f"prefix-commit kernel: row_ls must be 2-d, got {row_ls.dim()}-d")
    m, f = row_ls.shape
    dev = kernel.check(
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
    if n_mom == 0 or m == 0 or f == 0:  # nothing to sum: no launch
        return torch.zeros((n_mom, m), dtype=torch.int64, device=dev)
    bulk = f % 4 == 0 and row_ls.data_ptr() % 16 == 0 and cand_ls.data_ptr() % 16 == 0
    rows = _chunk_rows(m, f, _kernel.sm_count(dev))
    chunks = -(-m // rows)
    # Zeros: rows outside need stay so, and where F spans several column
    # tiles the tiles add into it
    out = torch.zeros((n_mom, m), dtype=torch.int64, device=dev)
    # With segments: the ticket, then each chunk's flagged tail or prefix a
    # column (the look-back's words), zeroed
    status = None
    if seg_start is not None:
        status = torch.zeros((1 + chunks * f,), dtype=torch.int64, device=dev)
    kernel.launch(
        "bb_prefix_commit", dev, row_ls, cand_ls, order, mask, seg_start, need,
        new_n, old_n, status, out,
        m, f, rows, int(_radius(criterion)), int(_reads_old(criterion)), int(bulk),
    )
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
