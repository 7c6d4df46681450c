r"""Packed-Tanimoto tile search: CUDA kernel wrappers (sorted and per-row
launch modes), sort plan and plain PyTorch version.

Port of ``bblean_tpu/ops/pallas_search2.py`` (``sorted_search_plan``,
``tile_search_planned``, ``tile_search_sorted``) and of
``bblean_tpu/ops/pallas_search.py`` (``tile_search_pallas``).  The batch
engine routes each pending row to a group, then scores the row against that
group's packed-centroid tile.  The sorted mode sorts rows by routed group so
that the kernel (``csrc/tile_search.cu``) stages each distinct group's tile
once; the per-row mode (:func:`tile_search_rows`) takes rows in any order,
one warp per row, with no sort.

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

__all__ = [
    "sorted_search_plan",
    "tile_search_planned",
    "tile_search_sorted",
    "tile_search_rows",
    "search_tiles_plain",
    "launches",
    "row_launches",
]

_NEG = -2.0
_SOURCE = "tile_search.cu"
_SMEM_LIMIT = 232_448  # bytes of shared memory one block may use on Hopper
# Rows of the plain version's gather per chunk, bounded so that the
# (rows, Fc, F8) intermediates stay near this many bytes
_PLAIN_CHUNK_BYTES = 1 << 27

# Kernel launches made by this module, per launch mode (the counts a run
# reads to show that its path went through the CUDA kernels): sorted mode
# (tile_search_planned / tile_search_sorted) and per-row mode
# (tile_search_rows)
launches = 0
row_launches = 0


_kernel_lib: ctypes.CDLL | None = None


def _lib() -> ctypes.CDLL:
    global _kernel_lib
    if _kernel_lib is None:
        from bblean_tpu_torch._build import load_kernel_library

        lib = load_kernel_library(_SOURCE)
        p = ctypes.c_void_p
        lib.bb_tile_search.argtypes = [p] * 10 + [ctypes.c_int] * 4 + [p]
        lib.bb_tile_search.restype = ctypes.c_int
        lib.bb_tile_search_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.bb_tile_search_smem_bytes.restype = ctypes.c_longlong
        lib.bb_tile_search_rows.argtypes = [p] * 9 + [ctypes.c_int] * 4 + [p]
        lib.bb_tile_search_rows.restype = ctypes.c_int
        lib.bb_tile_search_rows_smem_bytes.argtypes = [ctypes.c_int]
        lib.bb_tile_search_rows_smem_bytes.restype = ctypes.c_longlong
        _kernel_lib = lib
    return _kernel_lib


def _popcount_u8(x: torch.Tensor) -> torch.Tensor:
    r"""Per-byte popcount of a uint8 tensor (SWAR, stays uint8)."""
    x = x - ((x >> 1) & 0x55)
    x = (x & 0x33) + ((x >> 2) & 0x33)
    return (x + (x >> 4)) & 0x0F


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
    gather reads it (:func:`_clamp_group`); the kernels do the same.
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


def sorted_search_plan(key: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    r"""Sort schedule for the kernel: (order, sorted keys), a stable sort of
    the rows by routed group.

    ``key`` is the per-row routed group (rows to skip may carry a guard
    group).  The batch engine's routed groups are step-constant, so the
    plan is made once per step and reused by every wide insert round.  The
    TPU version also returned a next-distinct-group table for its DMA
    prefetcher; the CUDA kernel needs none.
    """
    skey, order = torch.sort(key, stable=True)
    return order, skey


def _check_kernel_inputs(tensors: dict) -> None:
    r"""Raise unless every tensor is on one CUDA device with the kernel's
    dtype, rank and contiguity, and the shapes agree.  ``tensors`` maps a
    name to (tensor, dtype, ndim); the first is the (M, F8) row table, whose
    device is the launch device, and every 1-d tensor must have M rows."""
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
        if ndim == 1 and t.shape[0] != m:
            raise ValueError(f"tile search kernel: {name} must have {m} rows")


def _launch(
    srows, spops, skey, order, t_pk, t_pops, t_slot, pending
) -> tuple[torch.Tensor, torch.Tensor]:
    global launches
    _check_kernel_inputs(
        {
            "srows": (srows, torch.uint8, 2),
            "spops": (spops, torch.int32, 1),
            "skey": (skey, torch.int32, 1),
            "order": (order, torch.int64, 1),
            "t_pk": (t_pk, torch.uint8, 3),
            "t_pops": (t_pops, torch.int32, 2),
            "t_slot": (t_slot, torch.int32, 2),
            "pending": (pending, torch.bool, 1),
        }
    )
    dev = srows.device
    m, f8 = srows.shape
    g, fc = t_pk.shape[:2]
    lib = _lib()
    smem = lib.bb_tile_search_smem_bytes(fc, f8)
    if smem > _SMEM_LIMIT:
        raise ValueError(
            f"tile search kernel: a Fc={fc} x F8={f8} tile needs {smem} B of "
            f"shared memory, more than the {_SMEM_LIMIT} B a block may use"
        )
    out_sim = torch.empty(m, dtype=torch.float32, device=dev)
    out_slot = torch.empty(m, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.bb_tile_search(
            srows.data_ptr(), spops.data_ptr(), skey.data_ptr(),
            order.data_ptr(), t_pk.data_ptr(), t_pops.data_ptr(),
            t_slot.data_ptr(), pending.data_ptr(), out_sim.data_ptr(),
            out_slot.data_ptr(), m, g, fc, f8, stream,
        )
    if err != 0:
        raise RuntimeError(f"tile search kernel launch failed: CUDA error {err}")
    launches += 1
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
) -> tuple[torch.Tensor, torch.Tensor]:
    r"""Search on a precomputed plan; outputs in row order.

    Rows keyed to a group they no longer need (assigned in an earlier
    round) are masked by the current ``pending``.
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
    return _launch(srows, spops, skey, order, t_pk, t_pops, t_slot, pending)


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
    not pending are keyed to it so that they collect in one run the kernel
    skips.  When None they keep their routed group (they are masked either
    way).
    """
    key = row_group if guard_group is None else torch.where(
        pending, row_group, guard_group
    )
    order, skey = sorted_search_plan(key)
    return tile_search_planned(
        row_pk[order], row_pop[order], skey, order, t_pk, t_pops, t_slot,
        pending,
    )


def _launch_rows(
    row_pk, row_pop, row_group, t_pk, t_pops, t_slot, pending
) -> tuple[torch.Tensor, torch.Tensor]:
    global row_launches
    _check_kernel_inputs(
        {
            "row_pk": (row_pk, torch.uint8, 2),
            "row_pop": (row_pop, torch.int32, 1),
            "row_group": (row_group, torch.int32, 1),
            "t_pk": (t_pk, torch.uint8, 3),
            "t_pops": (t_pops, torch.int32, 2),
            "t_slot": (t_slot, torch.int32, 2),
            "pending": (pending, torch.bool, 1),
        }
    )
    dev = row_pk.device
    m, f8 = row_pk.shape
    g, fc = t_pk.shape[:2]
    lib = _lib()
    smem = lib.bb_tile_search_rows_smem_bytes(f8)
    if smem > _SMEM_LIMIT:
        raise ValueError(
            f"per-row tile search kernel: F8={f8} rows need {smem} B of "
            f"shared memory, more than the {_SMEM_LIMIT} B a block may use"
        )
    out_sim = torch.empty(m, dtype=torch.float32, device=dev)
    out_slot = torch.empty(m, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.bb_tile_search_rows(
            row_pk.data_ptr(), row_pop.data_ptr(), row_group.data_ptr(),
            t_pk.data_ptr(), t_pops.data_ptr(), t_slot.data_ptr(),
            pending.data_ptr(), out_sim.data_ptr(), out_slot.data_ptr(),
            m, g, fc, f8, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"per-row tile search kernel launch failed: CUDA error {err}"
        )
    row_launches += 1
    return out_sim, out_slot


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
    On the card it launches ``bb_tile_search_rows`` of
    ``csrc/tile_search.cu``: one warp per row, no sort and no plan.  A row
    that is not pending reads no tile and gets (-2, 0); a pending row whose
    group is outside ``[0, G)`` reads its group as JAX's gather does
    (wrapped once if negative, then clamped).
    """
    if row_pk.device.type == "cpu":
        return search_tiles_plain(
            row_pk, row_pop, row_group, t_pk, t_pops, t_slot, pending
        )
    return _launch_rows(row_pk, row_pop, row_group, t_pk, t_pops, t_slot, pending)
