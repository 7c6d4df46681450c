r"""Group route: argmax (and max) Tanimoto of rows over the live group
centroids, with a CUDA kernel on the card and the plain PyTorch version.

Port of ``bblean_tpu/engine/batch.py::_route_groups`` (``:203-244``) and of
its similarity twin ``bblean_tpu/parallel/sharded.py::_best_group_sim``
(``:117-148``).  Neither is a Pallas kernel: on the TPU each is a
``lax.fori_loop`` over blocks of ``block`` groups inside a jitted XLA
program, an int8 ``dot_general`` on the MXU followed by the Tanimoto, the
mask and a max (and argmax).  The batch engine routes every row of a step
with :func:`route_groups` (fit, predict); the sharded merge gates each
received group on :func:`best_group_sim`.

Contract of both, equal to the JAX functions bit for bit.  Column
``c = b * block + j`` of block ``b`` reads centroid row ``s0 + j`` with
``s0 = min(b * block, G_cap - block)`` (``lax.dynamic_slice`` clamps its
start; only the last block can be clamped, and only when ``block`` does
not divide ``G_cap``), for ``block = min(block, G_cap)`` and
``ceil(g_num / block)`` blocks.  ``inter`` is the int32 dot product of the
0/1 planes, ``sim = f32(inter) / max(f32(pop_r + pop_g) - f32(inter), 1)``
with IEEE division, and a column ``c >= g_num`` (or, for the route, a row
that is not pending) scores -2.

- :func:`route_groups`: the smallest ``c`` among the columns of largest
  ``sim``, starting from ``(-2, 0)``, as int32; 0 where a row is not
  pending.
- :func:`best_group_sim`: the largest ``sim``, starting from -2, as f32.

The plain versions (:func:`route_groups_plain`, :func:`best_group_sim_plain`)
run ``torch._int_mm`` per block, then elementwise ops; the card runs the
kernels of ``csrc/route.cu`` (``ops/_kernel.py``: how a wrapper dispatches).

- The TMA path (F % 16 == 0, F <= 16,384, 16-byte-aligned tables; every
  call of the engine and the merge): a persistent, warp-specialised kernel,
  one block an SM, a producer warp keeping TMA loads in flight and two
  consumer warpgroups on ``wgmma`` int8 (128 x 256 tiles), with the
  Tanimoto and a division-free running (arg)max in registers.  Its work
  units are (row tile, column range); :func:`_plan` chooses the ranges.
  Counted in ``wgmma_launches``.
- The generic path (anything else): an ``mma.sync`` kernel with byte
  loads, one block per (row tile, range).  Counted in ``generic_launches``.

Either is followed by a small kernel that combines the ranges' partials
in column order.  ``route_launches`` and ``best_sim_launches`` count the
calls of each wrapper that launched, on either path.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from bblean_tpu_torch.ops import _kernel
from bblean_tpu_torch.ops.tanimoto import _int8_gram, _pad_int8

__all__ = [
    "route_groups",
    "best_group_sim",
    "route_groups_plain",
    "best_group_sim_plain",
    "route_launches",
    "best_sim_launches",
    "generic_launches",
    "wgmma_launches",
    "TILE_ROWS",
    "TILE_COLS",
]

_NEG = -2.0
_I32 = torch.int32

# Rows and group columns of one tile of the TMA path (its kBM, kBN); the
# column ranges are whole multiples of TILE_COLS
TILE_ROWS = 128
TILE_COLS = 256

# Kernel launches made by this module (the counts a run reads to show that
# its path went through the CUDA kernels): the route (route_groups), the
# twin (best_group_sim), and, of either, those that took the TMA path
# (wgmma) and those that took the generic path (ordinary loads: F % 16 != 0,
# F > 16,384 or a table not 16-byte aligned)
route_launches = 0
best_sim_launches = 0
wgmma_launches = 0
generic_launches = 0
_kernel.count_launches(
    __name__, "route_launches", "best_sim_launches", "wgmma_launches", "generic_launches"
)

# A unit's cost beyond its column tiles (its rows' popcounts, the quad
# reduction and the partial's writes), in column tiles, for _plan
_UNIT_COST = 0.1
# Widest rows the TMA path takes (route.cu's kMaxF)
_TMA_MAX_F = 16384
# The offset of a failed tensor-map encoding in bb_route's return value
_ENCODE_ERROR = 100000


def _verify(lib) -> None:
    tile = (lib.bb_route_tile(0), lib.bb_route_tile(1))
    if tile != (TILE_ROWS, TILE_COLS):
        raise RuntimeError(
            f"route.cu has tiles of {tile[0]} rows x {tile[1]} groups, "
            f"the wrapper expects {TILE_ROWS} x {TILE_COLS}"
        )


def _error_text(err: int) -> str | None:
    if err >= _ENCODE_ERROR:
        return f"route kernel: TMA descriptor refused: CUresult {err - _ENCODE_ERROR}"
    return None


kernel = _kernel.Kernel(
    "route", "route.cu",
    {"bb_route": ("p" * 8 + "i" * 12 + "p", "i"), "bb_route_tile": ("i", "i")},
    verify=_verify, error_text=_error_text,
)


def route_groups_plain(
    row_cent: torch.Tensor,  # (M, F) int8 (0/1 values)
    row_pop: torch.Tensor,  # (M,) int32
    g_cent: torch.Tensor,  # (G_cap, F) int8 (0/1 values)
    g_pops: torch.Tensor,  # (G_cap,) int32
    g_num: int,  # live groups (read on the host once per step)
    pending: torch.Tensor,  # (M,) bool
    block: int,
) -> torch.Tensor:
    r"""Argmax Tanimoto over live group centroids, in blocks of ``block``
    groups (first argmax overall: a later block wins only when strictly
    better)."""
    m = row_cent.shape[0]
    dev = row_cent.device
    g_cap = g_cent.shape[0]
    block = min(block, g_cap)
    n_blocks = (g_num + block - 1) // block
    a_pad = _pad_int8(row_cent, 17)
    best_sim = torch.full((m,), _NEG, dtype=torch.float32, device=dev)
    best_idx = torch.zeros((m,), dtype=_I32, device=dev)
    iota = torch.arange(block, dtype=_I32, device=dev)
    for b in range(n_blocks):
        start = b * block
        s0 = min(start, g_cap - block)  # lax.dynamic_slice clamps its start
        cb = g_cent[s0 : s0 + block]
        pb = g_pops[s0 : s0 + block]
        inter = _int8_gram(a_pad, cb, m).to(torch.float32)
        union = (row_pop[:, None] + pb[None, :]).to(torch.float32) - inter
        sims = inter / union.clamp_min(1.0)
        cols = start + iota
        sims = torch.where((cols < g_num)[None, :] & pending[:, None], sims, _NEG)
        blk_best = sims.amax(dim=1)
        blk_idx = start + torch.argmax(sims, dim=1).to(_I32)
        take = blk_best > best_sim
        best_sim = torch.where(take, blk_best, best_sim)
        best_idx = torch.where(take, blk_idx, best_idx)
    return torch.where(pending, best_idx, 0)


def best_group_sim_plain(
    q_cent: torch.Tensor,  # (Q, F) int8 query centroids (0/1 values)
    q_pops: torch.Tensor,  # (Q,) int32
    g_cent: torch.Tensor,  # (G_cap, F) int8 (0/1 values)
    g_pops: torch.Tensor,  # (G_cap,) int32
    g_num: int,  # live groups (read on the host by the caller)
    block: int,
) -> torch.Tensor:
    r"""Max Tanimoto of each query centroid over the live groups, in blocks
    of ``block`` groups (the similarity twin of ``route_groups_plain``)."""
    q = q_cent.shape[0]
    dev = q_cent.device
    g_cap = g_cent.shape[0]
    block = min(block, g_cap)
    n_blocks = (g_num + block - 1) // block
    a_pad = _pad_int8(q_cent, 17)
    best = torch.full((q,), _NEG, dtype=torch.float32, device=dev)
    iota = torch.arange(block, dtype=_I32, device=dev)
    for b in range(n_blocks):
        start = b * block
        s0 = min(start, g_cap - block)  # lax.dynamic_slice clamps its start
        pb = g_pops[s0 : s0 + block]
        inter = _int8_gram(a_pad, g_cent[s0 : s0 + block], q).to(torch.float32)
        union = (q_pops[:, None] + pb[None, :]).to(torch.float32) - inter
        sims = inter / union.clamp_min(1.0)
        sims = torch.where((start + iota < g_num)[None, :], sims, _NEG)
        best = torch.maximum(best, sims.amax(dim=1))
    return best


def _last_block(g_cap: int, g_num: int, block: int) -> tuple[int, int]:
    r"""(first column of the last block, the shift of its centroid rows):
    column ``c`` reads row ``c + shift`` where ``c >= start``, row ``c``
    elsewhere.  Only the last block can be clamped: every earlier block
    ends below ``g_num <= G_cap``."""
    block = min(block, g_cap)
    start = (max(g_num, 1) - 1) // block * block
    return start, min(start, g_cap - block) - start


class _Plan(NamedTuple):
    r"""The column ranges and work units of one call (route.cu's Ranges)."""

    span: int  # columns a range: a multiple of TILE_COLS
    s1: int  # ranges in [0, seg1_end)
    seg1_end: int  # first column of the shifted last block, else g_num
    n_ranges: int
    units: int  # row tiles x ranges
    grid: int  # persistent blocks of the TMA path: min(units, SMs)


@functools.lru_cache(maxsize=4096)
def _plan(m: int, g_num: int, last_start: int, shift: int, n_sm: int) -> _Plan:
    r"""Cut the live columns ``[0, g_num)`` into ranges for ``m`` rows on
    ``n_sm`` SMs.  Where the last block is shifted (``shift != 0``) the
    columns split at ``last_start`` into two segments, and no range crosses
    it; each segment is cut into ranges of ``per`` column tiles (its last
    range shorter).  ``per`` minimises the waves of units times a unit's
    cost, ``ceil(units / n_sm) * (per + _UNIT_COST)``, the larger ``per`` on
    a tie (fewer partials to combine): at 8,192 rows that is one unit a
    block on 128 SMs from 1,646 live groups (7 tiles) to 43,008 (168), and
    units of 7 tiles in 18 waves at 65,536 (256)."""
    seg1_end = last_start if shift else g_num
    row_tiles = -(-m // TILE_ROWS)
    tiles = [-(-n // TILE_COLS) for n in (seg1_end, g_num - seg1_end) if n > 0]
    best = None
    for per in range(1, max(tiles) + 1):
        n_ranges = sum(-(-t // per) for t in tiles)
        units = row_tiles * n_ranges
        cost = -(-units // n_sm) * (per + _UNIT_COST)
        if best is None or cost <= best[0]:
            best = (cost, per, n_ranges, units)
    _cost, per, n_ranges, units = best
    span = per * TILE_COLS
    return _Plan(span, -(-seg1_end // span), seg1_end, n_ranges, units, min(units, n_sm))


def _launch(rows, pops, g_cent, g_pops, g_num, pending, block) -> torch.Tensor:
    r"""One launch of the kernel: the route when ``pending`` is given (int32
    group per row), the twin when it is None (f32 best sim per row).  The
    tensors' ranks are checked, then their shapes' relations and
    ``0 <= g_num <= G_cap``."""
    global route_launches, best_sim_launches, wgmma_launches, generic_launches
    argmax = pending is not None
    mat, vec = (None, None), (None,)
    checked = {
        "rows": (rows, torch.int8, mat),
        "pops": (pops, torch.int32, vec),
        "g_cent": (g_cent, torch.int8, mat),
        "g_pops": (g_pops, torch.int32, vec),
        "pending": (pending, torch.bool, vec),
    }
    dev = kernel.check(checked)
    (m, f), (g_cap, gf) = rows.shape, g_cent.shape
    if f < 1 or g_cap < 1 or gf != f:
        raise ValueError(
            f"route kernel: rows (M, {f}) and centroids ({g_cap}, {gf}) must "
            f"share a width of at least 1 over at least one group"
        )
    for name, (t, _dt, shape) in checked.items():
        want = g_cap if name == "g_pops" else m
        if t is not None and len(shape) == 1 and t.shape[0] != want:
            raise ValueError(f"route kernel: {name} must have {want} rows")
    if not 0 <= g_num <= g_cap or block < 1:
        raise ValueError(
            f"route kernel: need 0 <= g_num <= G_cap and block >= 1; got "
            f"g_num={g_num}, G_cap={g_cap}, block={block}"
        )
    if m == 0 or g_num == 0:  # no live column: nothing to launch
        if argmax:
            return torch.zeros(m, dtype=_I32, device=dev)
        return torch.full((m,), _NEG, dtype=torch.float32, device=dev)
    out = torch.empty(m, dtype=_I32 if argmax else torch.float32, device=dev)
    tma = (
        f % 16 == 0 and f <= _TMA_MAX_F
        and rows.data_ptr() % 16 == 0 and g_cent.data_ptr() % 16 == 0
    )
    last_start, shift = _last_block(g_cap, g_num, block)
    plan = _plan(m, g_num, last_start, shift, _kernel.sm_count(dev))
    part_sim = torch.empty((plan.n_ranges, m), dtype=torch.float32, device=dev)
    part_idx = torch.empty((plan.n_ranges, m) if argmax else (0,), dtype=_I32, device=dev)
    kernel.launch(
        "bb_route", dev, rows, pops, g_cent, g_pops, pending, part_sim,
        part_idx if argmax else None, out,
        m, f, g_cap, g_num, plan.span, plan.s1, plan.seg1_end, shift,
        plan.n_ranges, plan.grid, int(argmax), int(tma),
    )
    if argmax:
        route_launches += 1
    else:
        best_sim_launches += 1
    wgmma_launches += tma
    generic_launches += not tma
    return out


def route_groups(
    row_cent: torch.Tensor,  # (M, F) int8 (0/1 values)
    row_pop: torch.Tensor,  # (M,) int32
    g_cent: torch.Tensor,  # (G_cap, F) int8 (0/1 values)
    g_pops: torch.Tensor,  # (G_cap,) int32
    g_num: int,  # live groups (read on the host once per step)
    pending: torch.Tensor,  # (M,) bool
    block: int,
) -> torch.Tensor:
    r"""Routed group per row (int32): the first argmax Tanimoto over the
    live group centroids, 0 where the row is not pending.

    Replaces ``bblean_tpu/engine/batch.py:203`` (``_route_groups``).  On
    the card one call of ``bb_route`` (``csrc/route.cu``: the product, then
    the ranges' combination); on the CPU
    :func:`route_groups_plain`.
    """
    if row_cent.device.type == "cpu":
        return route_groups_plain(row_cent, row_pop, g_cent, g_pops, g_num, pending, block)
    return _launch(row_cent, row_pop, g_cent, g_pops, g_num, pending, block)


def best_group_sim(
    q_cent: torch.Tensor,  # (Q, F) int8 query centroids (0/1 values)
    q_pops: torch.Tensor,  # (Q,) int32
    g_cent: torch.Tensor,  # (G_cap, F) int8 (0/1 values)
    g_pops: torch.Tensor,  # (G_cap,) int32
    g_num: int,  # live groups (read on the host by the caller)
    block: int,
) -> torch.Tensor:
    r"""Max Tanimoto (f32) of each query centroid over the live groups, -2
    where there is none.

    Replaces ``bblean_tpu/parallel/sharded.py:117`` (``_best_group_sim``).
    On the card one launch of ``bb_route`` (``csrc/route.cu``) with the max
    epilogue; on the CPU :func:`best_group_sim_plain`.
    """
    if q_cent.device.type == "cpu":
        return best_group_sim_plain(q_cent, q_pops, g_cent, g_pops, g_num, block)
    return _launch(q_cent, q_pops, g_cent, g_pops, g_num, None, block)
