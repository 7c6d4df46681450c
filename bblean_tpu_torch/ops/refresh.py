r"""The batch step's refresh, with a CUDA kernel on the card and the plain
PyTorch version.

Counterpart of ``bblean_tpu/engine/batch.py:891`` ``_refresh_touched``,
which JAX fuses inside its jitted step: once a step, the committed rows are
folded into their groups' sums and counts, and the tile centroids of the
clusters and the routing centroids of the groups the step touched are
revoted.

Contract (int32 sums wrap; tables updated in place).  A row ``r`` commits
where ``0 <= assigned[r] < C_cap``, to cluster ``s = assigned[r]`` of group
``g = group[s]``:

- ``g_ls[g] += row_ls[r]`` and ``g_n[g] += row_n[r]``;
- then each distinct committed cluster, at ``max(n[s], 1)``: the majority
  vote (``ops/isim.py::majority_centroid_from_sums``, its ``n <= 1`` rule
  included) of its pool row ``ls[ls_ref[s]]``, or of its cell's bits where
  ``ls_ref[s] < 0`` (a singleton), packed into ``t_pk`` and counted into
  ``t_pops`` at its cell ``(group[s], pos[s])``;
- and each distinct committed group, at ``max(g_n[g], 1)``: the vote of
  ``g_ls[g]`` into ``g_cent`` (int8 0/1) and its popcount into ``g_pops``.

``row_single[r]`` promises that ``row_ls[r]`` is the bits of ``row_pk[r]``
(a row of one fingerprint; the step's row producers set it): the kernel
then reads the row's packed bytes in place of its 4F bytes of sums.
``order``, a permutation of the rows, is the order in which the kernel
adds them (the step's sort plan, by routed group, makes the runs of one
group long); it does not change the result.  The plain version reads none
of the three.

Nothing is written at an index past a table's capacity (JAX's
``mode="drop"``).  The kernel's tables equal the plain version's bit for
bit, whatever the order of its atomic adds: they are integer adds.

``launches`` counts the calls that launched the kernel of
``csrc/refresh.cu`` (``ops/_kernel.py``: how a wrapper dispatches); each
launches its two phases: the fold, then the votes.
The kernel's scratch, two hash sets and two lists of the touched groups
and clusters, is made once per (device, stream, rows) and left cleared by
each call.
"""

from __future__ import annotations

import torch

from bblean_tpu_torch.ops import _kernel
from bblean_tpu_torch.ops.isim import majority_centroid_from_sums
from bblean_tpu_torch.ops.packing import (
    pack_fingerprints_device,
    unpack_fingerprints_device,
)
from bblean_tpu_torch.ops.segments import (
    _BIG,
    _drop_add_,
    _drop_set_,
    _flat2,
    _group_ids_by_key,
    _isum,
    _segment_sum,
)

__all__ = [
    "refresh_touched",
    "refresh_touched_plain",
    "launches",
]

_I32 = torch.int32

# Calls of refresh_touched that launched the kernel
launches = 0
_kernel.count_launches(__name__, "launches")

kernel = _kernel.Kernel("refresh", "refresh.cu", {"bb_refresh": ("p" * 18 + "i" * 7 + "p", "i")})
# (device index, stream, rows) -> the kernel's scratch, all zero between calls
_scratch: dict[tuple[int, int, int], torch.Tensor] = {}


def refresh_touched_plain(
    g_ls: torch.Tensor,  # (G_cap, F) int32, in place
    g_n: torch.Tensor,  # (G_cap,) int32, in place
    t_pk: torch.Tensor,  # (G_cap, Fc, F8) uint8 tiles, in place
    t_pops: torch.Tensor,  # (G_cap, Fc) int32, in place
    g_cent: torch.Tensor,  # (G_cap, F) int8, in place
    g_pops: torch.Tensor,  # (G_cap,) int32, in place
    ls: torch.Tensor,  # (P_cap, F) int32 pool
    ls_ref: torch.Tensor,  # (C_cap,) int32
    n: torch.Tensor,  # (C_cap,) int32
    group: torch.Tensor,  # (C_cap,) int32
    pos: torch.Tensor,  # (C_cap,) int32
    assigned: torch.Tensor,  # (M,) int32 slot of each row, -1 = not committed
    row_ls: torch.Tensor,  # (M, F) int32
    row_n: torch.Tensor,  # (M,) int32
    row_pk: torch.Tensor,  # (M, F8) uint8 (the kernel's; not read here)
    row_single: torch.Tensor,  # (M,) bool (the kernel's; not read here)
    order: torch.Tensor,  # (M,) int64 (the kernel's; not read here)
) -> None:
    r"""The module's contract with torch ops on (M, F) planes."""
    guard_c = n.shape[0] - 1
    n_features = g_ls.shape[1]

    ok = assigned >= 0
    slots = torch.where(ok, assigned, guard_c).long()  # guard ok for gathers
    groups = group[slots]

    # Group CF accumulation, pre-aggregated per group (one writer each)
    m = assigned.shape[0]
    gkey = torch.where(ok, groups, _BIG)
    gorder, ggrp, gstart = _group_ids_by_key(gkey)
    ggrp_l = ggrp.long()
    ok_sorted = ok[gorder]
    grp_sum_ls = _segment_sum(
        torch.where(ok_sorted[:, None], row_ls[gorder], 0), ggrp, m
    )[ggrp_l]
    grp_sum_n = _segment_sum(
        torch.where(ok_sorted, row_n[gorder], 0), ggrp, m
    )[ggrp_l]
    writer = gstart & ok_sorted
    g_idx = groups[gorder]
    _drop_add_(g_ls, g_idx, grp_sum_ls, writer)
    _drop_add_(g_n, g_idx, grp_sum_n, writer)
    del grp_sum_ls

    # Tile entries: one writer per distinct touched cluster; its sums are
    # the pool row when allocated, else the exact singleton bits of its cell
    skey = torch.where(ok, slots.to(_I32), _BIG)
    sorder, _sgrp, sstart = _group_ids_by_key(skey)
    writer_c = sstart & ok[sorder]
    slots_s = slots[sorder]
    ref = ls_ref[slots_s]
    cell_g, cell_p = group[slots_s].long(), pos[slots_s].long()
    bits = unpack_fingerprints_device(t_pk[cell_g, cell_p], n_features).to(_I32)
    t_ls = torch.where((ref >= 0)[:, None], ls[ref.clamp_min(0).long()], bits)
    del bits
    t_n = n[slots_s]
    cents = majority_centroid_from_sums(t_ls, t_n.clamp_min(1))
    del t_ls
    cell = group[slots_s] * t_pk.shape[1] + pos[slots_s]
    _drop_set_(_flat2(t_pk), cell, pack_fingerprints_device(cents), writer_c)
    _drop_set_(_flat2(t_pops), cell, _isum(cents, -1), writer_c)
    del cents

    # Routing centroids: one writer per distinct touched group (g_ls is
    # already updated above)
    groups_s = torch.where(ok_sorted, g_idx, 0).long()
    g_cents = majority_centroid_from_sums(g_ls[groups_s], g_n[groups_s].clamp_min(1))
    _drop_set_(g_cent, g_idx, g_cents.to(g_cent.dtype), writer)
    _drop_set_(g_pops, g_idx, _isum(g_cents, -1), writer)


def _scratch_for(dev: torch.device, stream: int, m: int) -> tuple[torch.Tensor, int]:
    r"""The kernel's scratch for ``m`` rows on ``stream`` of ``dev``, and
    its hash sets' size: a power of two of at least 2m words each."""
    h = max(2, 1 << (2 * m - 1).bit_length())
    key = (dev.index, stream, m)
    buf = _scratch.get(key)
    if buf is None:
        buf = _scratch[key] = torch.zeros((2 * h + 2 * m + 3,), dtype=_I32, device=dev)
    return buf, h


def _launch(*args) -> None:
    global launches
    if any(t is None for t in args):
        raise ValueError("refresh kernel: every tensor is needed on the card")
    (g_ls, g_n, t_pk, t_pops, g_cent, g_pops, ls, ls_ref, n, group, pos,
     assigned, row_ls, row_n, row_pk, row_single, order) = args
    if g_ls.dim() != 2 or row_ls.dim() != 2 or t_pk.dim() != 3:
        raise ValueError("refresh kernel: g_ls and row_ls must be 2-d, t_pk 3-d")
    m, f = row_ls.shape
    f8 = (f + 7) // 8
    g_cap, fc, _ = t_pk.shape
    c_cap, p_cap = group.shape[0], ls.shape[0]
    dev = kernel.check(
        {
            "g_ls": (g_ls, _I32, (g_cap, f)),
            "g_n": (g_n, _I32, (g_cap,)),
            "t_pk": (t_pk, torch.uint8, (g_cap, fc, f8)),
            "t_pops": (t_pops, _I32, (g_cap, fc)),
            "g_cent": (g_cent, torch.int8, (g_cap, f)),
            "g_pops": (g_pops, _I32, (g_cap,)),
            "ls": (ls, _I32, (p_cap, f)),
            "ls_ref": (ls_ref, _I32, (c_cap,)),
            "n": (n, _I32, (c_cap,)),
            "group": (group, _I32, (c_cap,)),
            "pos": (pos, _I32, (c_cap,)),
            "assigned": (assigned, _I32, (m,)),
            "row_ls": (row_ls, _I32, (m, f)),
            "row_n": (row_n, _I32, (m,)),
            "row_pk": (row_pk, torch.uint8, (m, f8)),
            "row_single": (row_single, torch.bool, (m,)),
            "order": (order, torch.int64, (m,)),
        },
    )
    if m == 0 or f == 0 or min(g_cap, fc, c_cap, p_cap) == 0:
        return  # nothing can be written: no launch
    scratch, h = _scratch_for(dev, torch.cuda.current_stream(dev).cuda_stream, m)
    kernel.launch(
        "bb_refresh", dev, g_ls, g_n, t_pk, t_pops, g_cent, g_pops, ls, ls_ref, n,
        group, pos, assigned, row_ls, row_pk, row_single, row_n, order, scratch,
        m, f, p_cap, c_cap, g_cap, fc, h - 1,
    )
    launches += 1


def refresh_touched(
    g_ls: torch.Tensor,  # (G_cap, F) int32, in place
    g_n: torch.Tensor,  # (G_cap,) int32, in place
    t_pk: torch.Tensor,  # (G_cap, Fc, F8) uint8 tiles, in place
    t_pops: torch.Tensor,  # (G_cap, Fc) int32, in place
    g_cent: torch.Tensor,  # (G_cap, F) int8, in place
    g_pops: torch.Tensor,  # (G_cap,) int32, in place
    ls: torch.Tensor,  # (P_cap, F) int32 pool
    ls_ref: torch.Tensor,  # (C_cap,) int32
    n: torch.Tensor,  # (C_cap,) int32
    group: torch.Tensor,  # (C_cap,) int32
    pos: torch.Tensor,  # (C_cap,) int32
    assigned: torch.Tensor,  # (M,) int32, -1 = not committed
    row_ls: torch.Tensor,  # (M, F) int32
    row_n: torch.Tensor,  # (M,) int32
    row_pk: torch.Tensor,  # (M, F8) uint8
    row_single: torch.Tensor,  # (M,) bool: row_ls is the bits of row_pk
    order: torch.Tensor,  # (M,) int64 permutation of the rows
) -> None:
    r"""Fold the committed rows into their groups and revote the touched
    clusters' tile cells and groups' routing centroids (the module's
    contract), in place.

    Replaces ``bblean_tpu/engine/batch.py:891``.  On the card one call of
    ``bb_refresh`` (``csrc/refresh.cu``), two launches; on the CPU
    :func:`refresh_touched_plain`.
    """
    args = (
        g_ls, g_n, t_pk, t_pops, g_cent, g_pops, ls, ls_ref, n, group, pos,
        assigned, row_ls, row_n, row_pk, row_single, order,
    )
    if g_ls.device.type == "cpu":
        return refresh_touched_plain(*args)
    return _launch(*args)
