r"""Packed-Tanimoto tile search: CUDA kernel wrappers (sorted and per-row
front ends), sort plan and plain PyTorch version.

Port of ``bblean_tpu/ops/pallas_search2.py`` (``sorted_search_plan``,
``tile_search_planned``, ``tile_search_sorted``) and of
``bblean_tpu/ops/pallas_search.py`` (``tile_search_pallas``).  The batch
engine routes each pending row to a group, then scores the row against that
group's packed-centroid tile.  Both front ends launch one kernel
(``csrc/tile_search.cu``) that streams each work item's tile through a ring
in shared memory.  The sorted front end sorts rows by routed group and cuts
the sorted rows into items of at most :data:`ITEM_ROWS` rows of one group
(:func:`sorted_search_plan`, whose item table a second kernel of the same
source builds), so each item reads its tile once for all its rows; the
per-row front end (:func:`tile_search_rows`) makes each row an item, with
no sort.

Contract, equal to ``bblean_tpu/engine/batch.py::_search_tiles``: equal
sims for every row, and equal slots wherever ``sim > -1.5``; rows that are
not pending get sim -2; the returned slot is clamped to ``>= 0``.

Dispatch: tensors on the CPU go to the plain version
(:func:`search_tiles_plain`); tensors on a CUDA device go to a kernel, and
anything the kernel does not take raises.  There is no fallback from a
kernel to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from bblean_tpu_torch.ops.popcount import _popcount_u8

__all__ = [
    "sorted_search_plan",
    "plan_items",
    "plan_items_plain",
    "tile_search_planned",
    "tile_search_sorted",
    "tile_search_rows",
    "search_tiles_plain",
    "launches",
    "row_launches",
    "generic_launches",
    "plan_launches",
    "ITEM_ROWS",
]

_NEG = -2.0
_SOURCE = "tile_search.cu"
_SMEM_LIMIT = 232_448  # bytes of shared memory one block may use on Hopper
# Rows of the plain version's gather per chunk, bounded so that the
# (rows, Fc, F8) intermediates stay near this many bytes
_PLAIN_CHUNK_BYTES = 1 << 27

# Rows of one sorted work item at most (the kernel's kItemRows)
ITEM_ROWS = 64

# Kernel launches made by this module (the counts a run reads to show that
# its path went through the CUDA kernel): the sorted front end
# (tile_search_planned / tile_search_sorted), the per-row front end
# (tile_search_rows), and, of either, those that took the generic path
# (no bulk copies: F8 % 16 != 0 or a pointer not 16-byte aligned); and the
# plan's item-table kernel (plan_items)
launches = 0
row_launches = 0
generic_launches = 0
plan_launches = 0


_kernel_lib: ctypes.CDLL | None = None


def _lib() -> ctypes.CDLL:
    global _kernel_lib
    if _kernel_lib is None:
        from bblean_tpu_torch._build import load_kernel_library

        lib = load_kernel_library(_SOURCE)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.bb_tile_search.argtypes = [p] * 11 + [i] * 5 + [p]
        lib.bb_tile_search.restype = i
        lib.bb_plan_items.argtypes = [p, p, i, p]
        lib.bb_plan_items.restype = i
        lib.bb_tile_search_smem_bytes.argtypes = [i, i, i]
        lib.bb_tile_search_smem_bytes.restype = ctypes.c_longlong
        lib.bb_tile_search_item_rows.argtypes = []
        lib.bb_tile_search_item_rows.restype = i
        if lib.bb_tile_search_item_rows() != ITEM_ROWS:
            raise RuntimeError(
                f"{_SOURCE} takes items of {lib.bb_tile_search_item_rows()} rows, "
                f"the plan makes {ITEM_ROWS}"
            )
        _kernel_lib = lib
    return _kernel_lib


def _clamp_group(group: torch.Tensor, n_groups: int) -> torch.Tensor:
    r"""Groups as JAX's gather ``t_pk[row_group]`` reads them: a negative
    group wraps once (+ G), then the index is clamped to ``[0, G - 1]``."""
    return torch.where(group < 0, group + n_groups, group).clamp(0, n_groups - 1)


def search_tiles_plain(
    row_pk: torch.Tensor,  # (M, F8) uint8
    row_pop: torch.Tensor,  # (M,) int32
    row_group: torch.Tensor,  # (M,) int32
    t_pk: torch.Tensor,  # (G, Fc, F8) uint8
    t_pops: torch.Tensor,  # (G, Fc) int32
    t_slot: torch.Tensor,  # (G, Fc) int32
    pending: torch.Tensor,  # (M,) bool
) -> tuple[torch.Tensor, torch.Tensor]:
    r"""Plain PyTorch version: a transcription of ``_search_tiles`` (gather
    the routed tile per row, AND + popcount, Tanimoto, first argmax).

    Rows go in chunks so that the gathered tiles stay bounded in memory.
    Returns (best_sim, best_slot); best_sim = -2 where no live cell exists
    or the row is not pending.  A group outside ``[0, G)`` is read as JAX's
    gather reads it (:func:`_clamp_group`); the kernel does the same.
    """
    m, f8 = row_pk.shape
    n_groups, fc = t_pk.shape[:2]
    step = max(1, _PLAIN_CHUNK_BYTES // max(fc * f8, 1))
    sims_out, slots_out = [], []
    for s in range(0, m, step):
        e = min(m, s + step)
        live = pending[s:e]
        g = _clamp_group(row_group[s:e], n_groups).long()
        tiles = t_pk[g]  # (c, Fc, F8) gather
        inter = _popcount_u8(tiles & row_pk[s:e, None, :]).sum(
            dim=-1, dtype=torch.int32
        )
        pops = t_pops[g]
        slots = t_slot[g]
        union = pops + row_pop[s:e, None] - inter
        sims = inter.to(torch.float32) / union.clamp_min(1).to(torch.float32)
        sims = torch.where((slots >= 0) & live[:, None], sims, _NEG)
        best_pos = torch.argmax(sims, dim=1, keepdim=True)
        sims_out.append(sims.gather(1, best_pos)[:, 0])
        slots_out.append(slots.gather(1, best_pos)[:, 0])
    best_sim = torch.cat(sims_out)
    best_slot = torch.cat(slots_out)
    return best_sim, best_slot.clamp_min(0)


def plan_items_plain(skey: torch.Tensor) -> torch.Tensor:
    r"""Plain PyTorch version of :func:`plan_items` (no host read)."""
    m = skey.shape[0]
    dev = skey.device
    pos = torch.arange(m, dtype=torch.int32, device=dev)
    new_run = torch.ones(m, dtype=torch.bool, device=dev)
    new_run[1:] = skey[1:] != skey[:-1]
    run_start = torch.cummax(torch.where(new_run, pos, 0), 0).values
    start = (pos - run_start) % ITEM_ROWS == 0
    idx = torch.cumsum(start, 0, dtype=torch.int32) - 1
    items = torch.full((m + 1,), m, dtype=torch.int32, device=dev)
    items.scatter_(0, torch.where(start, idx, m).long(), pos)
    items[m:] = idx[m - 1 :] + 1  # after the scatter: slot M took the rest
    return items


def plan_items(skey: torch.Tensor) -> torch.Tensor:
    r"""The search kernel's item table for sorted int32 keys (M,), built on
    the keys' device with no host read: (M + 1,) int32, ``items[:n]`` the
    sorted position where each of the ``n`` items starts and
    ``items[M] = n``.

    An item starts where the key changes and every :data:`ITEM_ROWS` rows
    within a run of equal keys; it ends where the next one starts (the last
    at M).  Entries ``items[n:M]`` are M.  Keys on the CPU take the plain
    version; keys on a CUDA device launch ``bb_plan_items`` of
    ``csrc/tile_search.cu`` (one block) or raise.
    """
    global plan_launches
    if skey.device.type == "cpu":
        return plan_items_plain(skey)
    if (
        skey.device.type != "cuda" or skey.dtype != torch.int32
        or skey.dim() != 1 or not skey.is_contiguous()
    ):
        raise ValueError(
            f"plan kernel needs contiguous 1-d int32 keys on one CUDA device; got "
            f"{skey.dim()}-d {skey.dtype} on {skey.device}"
        )
    m = skey.shape[0]
    items = torch.empty(m + 1, dtype=torch.int32, device=skey.device)
    lib = _lib()
    with torch.cuda.device(skey.device):
        stream = torch.cuda.current_stream(skey.device).cuda_stream
        err = lib.bb_plan_items(skey.data_ptr(), items.data_ptr(), m, stream)
    if err != 0:
        raise RuntimeError(f"plan kernel launch failed: CUDA error {err}")
    plan_launches += 1
    return items


def sorted_search_plan(
    key: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    r"""Sort schedule for the kernel: (order, sorted keys, item table), a
    stable sort of the rows by routed group and its :func:`plan_items`.

    ``key`` is the per-row routed group (rows to skip may carry a guard
    group).  The batch engine's routed groups are step-constant, so the
    plan is made once per step and reused by every wide insert round.  The
    TPU version also returned a next-distinct-group table for its DMA
    prefetcher; the CUDA kernel reads the item table instead.
    """
    skey, order = torch.sort(key, stable=True)
    return order, skey, plan_items(skey)


def _check_kernel_inputs(tensors: dict) -> None:
    r"""Raise unless every tensor is on one CUDA device with the kernel's
    dtype, rank and contiguity, and the shapes agree.  ``tensors`` maps a
    name to (tensor, dtype, ndim); the first is the (M, F8) row table, whose
    device is the launch device, and every 1-d tensor must have M rows
    (M + 1 for ``items``)."""
    first, (t0, _dt, _nd) = next(iter(tensors.items()))
    dev = t0.device
    for name, (t, dtype, ndim) in tensors.items():
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(
                f"tile search kernel needs every tensor on one CUDA device; "
                f"{name} is on {t.device}, {first} on {dev}"
            )
        if t.dtype != dtype or t.dim() != ndim:
            raise ValueError(
                f"tile search kernel: {name} must be {ndim}-d {dtype}, got "
                f"{t.dim()}-d {t.dtype}"
            )
        if not t.is_contiguous():
            raise ValueError(f"tile search kernel: {name} must be contiguous")
    m, f8 = t0.shape
    t_pk, t_pops, t_slot = (tensors[k][0] for k in ("t_pk", "t_pops", "t_slot"))
    g, fc, tf8 = t_pk.shape
    if m < 1 or fc < 1 or f8 < 1 or g < 1:
        raise ValueError(f"tile search kernel: empty shape M={m} Fc={fc} F8={f8} G={g}")
    if tf8 != f8 or t_pops.shape != (g, fc) or t_slot.shape != (g, fc):
        raise ValueError("tile search kernel: tile tables disagree in shape")
    for name, (t, _dt, ndim) in tensors.items():
        rows = m + 1 if name == "items" else m
        if ndim == 1 and t.shape[0] != rows:
            raise ValueError(f"tile search kernel: {name} must have {rows} rows")


def _launch(
    rows, pops, key, order, items, t_pk, t_pops, t_slot, pending
) -> tuple[torch.Tensor, torch.Tensor]:
    r"""One launch of the kernel: sorted front end when ``order`` and
    ``items`` are given, per-row front end when both are None."""
    global launches, row_launches, generic_launches
    checked = {
        "rows": (rows, torch.uint8, 2),
        "pops": (pops, torch.int32, 1),
        "key": (key, torch.int32, 1),
        "t_pk": (t_pk, torch.uint8, 3),
        "t_pops": (t_pops, torch.int32, 2),
        "t_slot": (t_slot, torch.int32, 2),
        "pending": (pending, torch.bool, 1),
    }
    sorted_mode = order is not None
    if sorted_mode:
        checked["order"] = (order, torch.int64, 1)
        checked["items"] = (items, torch.int32, 1)
    _check_kernel_inputs(checked)
    dev = rows.device
    m, f8 = rows.shape
    g, fc = t_pk.shape[:2]
    bulk = f8 % 16 == 0 and rows.data_ptr() % 16 == 0 and t_pk.data_ptr() % 16 == 0
    lib = _lib()
    smem = lib.bb_tile_search_smem_bytes(f8, int(bulk), int(sorted_mode))
    if smem > _SMEM_LIMIT:
        raise ValueError(
            f"tile search kernel: F8={f8} rows need {smem} B of shared memory "
            f"(at least two ring stages of 32 cells and {ITEM_ROWS} staged "
            f"rows; Fc does not count), more than the {_SMEM_LIMIT} B a block "
            f"may use"
        )
    out_sim = torch.empty(m, dtype=torch.float32, device=dev)
    out_slot = torch.empty(m, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.bb_tile_search(
            rows.data_ptr(), pops.data_ptr(), key.data_ptr(),
            order.data_ptr() if sorted_mode else None,
            items.data_ptr() if sorted_mode else None,
            t_pk.data_ptr(), t_pops.data_ptr(), t_slot.data_ptr(),
            pending.data_ptr(), out_sim.data_ptr(), out_slot.data_ptr(),
            m, g, fc, f8, int(bulk), stream,
        )
    if err != 0:
        raise RuntimeError(f"tile search kernel launch failed: CUDA error {err}")
    if sorted_mode:
        launches += 1
    else:
        row_launches += 1
    generic_launches += not bulk
    return out_sim, out_slot


def tile_search_planned(
    srows: torch.Tensor,  # (M, F8) uint8, sorted by the plan's order
    spops: torch.Tensor,  # (M,) int32, sorted
    skey: torch.Tensor,  # (M,) int32 sorted group keys
    order: torch.Tensor,  # (M,) int64 the plan's sort order
    t_pk: torch.Tensor,
    t_pops: torch.Tensor,
    t_slot: torch.Tensor,
    pending: torch.Tensor,  # (M,) bool CURRENT pending mask (row order)
    items: torch.Tensor,  # (M + 1,) int32 the plan's item table
) -> tuple[torch.Tensor, torch.Tensor]:
    r"""Search on a precomputed plan (:func:`sorted_search_plan`); outputs
    in row order.

    Rows keyed to a group they no longer need (assigned in an earlier
    round) are masked by the current ``pending``.  The plain version on
    the CPU does not read ``items``.
    """
    if srows.device.type == "cpu":
        sim_s, slot_s = search_tiles_plain(
            srows, spops, skey, t_pk, t_pops, t_slot, pending[order]
        )
        best_sim = torch.empty_like(sim_s)
        best_slot = torch.empty_like(slot_s)
        best_sim[order] = sim_s
        best_slot[order] = slot_s
        return best_sim, best_slot
    return _launch(srows, spops, skey, order, items, t_pk, t_pops, t_slot, pending)


def tile_search_sorted(
    row_pk: torch.Tensor,  # (M, F8) uint8
    row_pop: torch.Tensor,  # (M,) int32
    row_group: torch.Tensor,  # (M,) int32
    t_pk: torch.Tensor,  # (G, Fc, F8) uint8
    t_pops: torch.Tensor,  # (G, Fc) int32
    t_slot: torch.Tensor,  # (G, Fc) int32
    pending: torch.Tensor,  # (M,) bool
    guard_group: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    r"""Sort in-call, then search; same contract as ``_search_tiles``.

    ``guard_group``: a group whose tile holds no live cell; rows that are
    not pending are keyed to it so that they collect in items the kernel
    skips.  When None they keep their routed group (they are masked either
    way).
    """
    key = row_group if guard_group is None else torch.where(
        pending, row_group, guard_group
    )
    order, skey, items = sorted_search_plan(key)
    return tile_search_planned(
        row_pk[order], row_pop[order], skey, order, t_pk, t_pops, t_slot,
        pending, items,
    )


def tile_search_rows(
    row_pk: torch.Tensor,  # (M, F8) uint8
    row_pop: torch.Tensor,  # (M,) int32
    row_group: torch.Tensor,  # (M,) int32
    t_pk: torch.Tensor,  # (G, Fc, F8) uint8
    t_pops: torch.Tensor,  # (G, Fc) int32
    t_slot: torch.Tensor,  # (G, Fc) int32
    pending: torch.Tensor,  # (M,) bool
) -> tuple[torch.Tensor, torch.Tensor]:
    r"""Per-row search, rows in any order; same arguments as
    ``tile_search_pallas`` and same contract as ``_search_tiles``.

    Replaces the Pallas kernel ``bblean_tpu/ops/pallas_search.py:42``
    (``_search_kernel``, called through ``tile_search_pallas`` at ``:79``).
    On the card it launches ``bb_tile_search`` of ``csrc/tile_search.cu``
    with each row as a work item: no sort and no plan.  A row that is not
    pending reads no tile and gets (-2, 0); a pending row whose group is
    outside ``[0, G)`` reads its group as JAX's gather does (wrapped once if
    negative, then clamped).
    """
    if row_pk.device.type == "cpu":
        return search_tiles_plain(
            row_pk, row_pop, row_group, t_pk, t_pops, t_slot, pending
        )
    return _launch(
        row_pk, row_pop, row_group, None, None, t_pk, t_pops, t_slot, pending
    )
