r"""The insert round's pool and tile writes, with a CUDA kernel on the card
and the plain PyTorch version.

Counterpart of the lines of ``bblean_tpu/engine/batch.py`` that JAX fuses
inside its jitted step: ``:572-579`` (each joint creation's sums spread to
its rows), ``:660-684`` (step 7: the tile entries of the created clusters)
and ``:686-736`` (step 8: the linear-sum pool's promotions, adds and
pooled creations, the pool refs and the cluster counts).  The decisions
stay in the batch engine's torch code (O(M) masks and indices); this
module writes their results.

Contract (int32 sums wrap; tables updated in place).  Sorted positions
``p`` of the round's candidate sort (``aorder``, segments ``agrp``): a
segment's writer is its one position with ``seg_any[p]`` (``promo`` and
``adder`` hold only there), ``seg_add`` the sum of ``row_ls[aorder[p]]``
and ``seg_n`` the sum of ``row_n[aorder[p]]`` over its positions with
``committed[p]``.

- promotion: ``ls[ref_promo[p]] = bits(t_pk[group[best_s[p]], pos[best_s[p]]])
  + seg_add`` (the candidate's old singleton bits) and
  ``ls_ref[best_s[p]] = ref_promo[p]``;
- adder: ``ls[cand_ref[p]] += seg_add``;
- writer: ``n[best_s[p]] += seg_n``;
- ``create_pool[r]``: ``ls[ref_create[r]] = gj_ls[jseg[r]]`` where
  ``join_ok[r]``, else ``row_ls[r]``, and ``ls_ref[new_slot[r]] = ref_create[r]``;
- ``create_commit[r]``: ``n[new_slot[r]] += pool_created_n[r]``, and the
  majority vote of ``gj_ls[jseg[r]]`` where ``join_ok[r] & fits[r]``, else
  of ``row_ls[r]``, at ``created_n[r].clamp_min(1)``
  (``ops/isim.py::majority_centroid_from_sums``, its ``n <= 1`` rule
  included): its packed bits into ``t_pk``, its popcount into ``t_pops``
  and ``new_slot[r]`` into ``t_slot``, at ``cell[r]`` of the flattened
  (G * Fc) tiles.

``row_single[r]`` promises that ``row_ls[r]`` is the bits of ``row_pk[r]``
(a row of one fingerprint; the step's row producers set it once, never a
round): the kernel then reads the row's packed bytes, F / 8 of them, in
place of its 4F bytes of sums, and writes a flagged own creation's cell
(``created_n <= 1``) as its packed row.  The plain version reads neither.

Nothing is written outside the masks or at an index past a table's
capacity (JAX's ``mode="drop"``); kept indices are unique, so the guard
row keeps its value.  The kernel's tables equal the plain version's bit
for bit.

``launches`` counts the calls that launched the kernel of
``csrc/commit_writes.cu`` (``ops/_kernel.py``: how a wrapper dispatches);
each launches its two phases: the sets, refs and creations' counts, then
the adds, segment counts and tile cells.
"""

from __future__ import annotations

import torch

from bblean_tpu_torch.ops import _kernel
from bblean_tpu_torch.ops.isim import majority_centroid_from_sums
from bblean_tpu_torch.ops.packing import (
    pack_fingerprints_device,
    unpack_fingerprints_device,
)
from bblean_tpu_torch.ops.segments import _drop_add_, _drop_set_, _flat2, _segment_sum

__all__ = [
    "commit_writes",
    "commit_writes_plain",
    "launches",
]

_I32 = torch.int32

# Calls of commit_writes that launched the kernel
launches = 0
_kernel.count_launches(__name__, "launches")

kernel = _kernel.Kernel(
    "commit-writes", "commit_writes.cu", {"bb_commit_writes": ("p" * 33 + "i" * 6 + "p", "i")}
)

# The (M,) inputs, in argument order: name -> dtype (every argument before
# them is a table or an (M, .) row plane)
_ROW_INPUTS = {
    "row_single": torch.bool, "row_n": _I32, "aorder": torch.int64, "agrp": _I32,
    "committed": torch.bool, "seg_any": torch.bool, "promo": torch.bool,
    "adder": torch.bool, "ref_promo": _I32, "cand_ref": _I32, "best_s": _I32,
    "jseg": _I32, "join_ok": torch.bool, "fits": torch.bool, "create_pool": torch.bool,
    "ref_create": _I32, "create_commit": torch.bool, "created_n": _I32,
    "pool_created_n": _I32, "cell": _I32, "new_slot": _I32,
}


def commit_writes_plain(
    ls: torch.Tensor,  # (P_cap, F) int32 pool, in place
    t_pk: torch.Tensor,  # (G_cap, Fc, F8) uint8 tiles, in place
    t_pops: torch.Tensor,  # (G_cap, Fc) int32, in place
    t_slot: torch.Tensor,  # (G_cap, Fc) int32, in place
    ls_ref: torch.Tensor,  # (C_cap,) int32 pool ref of each cluster, in place
    n: torch.Tensor,  # (C_cap,) int32 cluster counts, in place
    group: torch.Tensor,  # (C_cap,) int32
    pos: torch.Tensor,  # (C_cap,) int32
    row_ls: torch.Tensor,  # (M, F) int32, row order
    row_pk: torch.Tensor,  # (M, F8) uint8, row order (the kernel's; not read here)
    gj_ls: torch.Tensor,  # (M, F) int32 joint creations' sums by segment
    row_single: torch.Tensor,  # (M,) bool (the kernel's; not read here)
    row_n: torch.Tensor,  # (M,) int32, row order
    aorder: torch.Tensor,  # (M,) int64 sorted -> row
    agrp: torch.Tensor,  # (M,) int32 segment of each sorted position
    committed: torch.Tensor,  # (M,) bool, sorted
    seg_any: torch.Tensor,  # (M,) bool, sorted: the segments' writers
    promo: torch.Tensor,  # (M,) bool, sorted
    adder: torch.Tensor,  # (M,) bool, sorted
    ref_promo: torch.Tensor,  # (M,) int32, sorted
    cand_ref: torch.Tensor,  # (M,) int32, sorted
    best_s: torch.Tensor,  # (M,) int32, sorted
    jseg: torch.Tensor,  # (M,) int32 row -> gj_ls row
    join_ok: torch.Tensor,  # (M,) bool
    fits: torch.Tensor,  # (M,) bool
    create_pool: torch.Tensor,  # (M,) bool
    ref_create: torch.Tensor,  # (M,) int32
    create_commit: torch.Tensor,  # (M,) bool
    created_n: torch.Tensor,  # (M,) int32
    pool_created_n: torch.Tensor,  # (M,) int32
    cell: torch.Tensor,  # (M,) int32
    new_slot: torch.Tensor,  # (M,) int32
) -> None:
    r"""The module's contract with torch ops on (M, F) planes."""
    m, n_features = row_ls.shape
    best_l = best_s.long()
    agrp_l = agrp.long()
    # The promoted candidates' old singleton bits, read before any tile write
    cand_bits = unpack_fingerprints_device(
        t_pk[group[best_l].long(), pos[best_l].long()], n_features
    ).to(_I32)
    gj_full_ls = gj_ls[jseg.long()]
    pool_created_ls = torch.where(join_ok[:, None], gj_full_ls, row_ls)

    # Step 7: tile entries of the created clusters
    created_ls = torch.where((join_ok & fits)[:, None], gj_full_ls, row_ls)
    del gj_full_ls
    c_cent = majority_centroid_from_sums(created_ls, created_n.clamp_min(1))
    del created_ls
    c_packed = pack_fingerprints_device(c_cent)
    _drop_set_(_flat2(t_pk), cell, c_packed, create_commit)
    _drop_set_(_flat2(t_pops), cell, c_cent.sum(-1, dtype=_I32), create_commit)
    _drop_set_(_flat2(t_slot), cell, new_slot, create_commit)
    del c_cent

    # Step 8: promotions, adds and pooled creations, one writer a segment
    seg_add_ls = _segment_sum(
        torch.where(committed[:, None], row_ls[aorder], 0), agrp, m
    )[agrp_l]
    _drop_set_(ls, ref_promo, cand_bits + seg_add_ls, promo)
    _drop_add_(ls, cand_ref, seg_add_ls, adder)
    _drop_set_(ls, ref_create, pool_created_ls, create_pool)
    _drop_set_(ls_ref, best_s, ref_promo, promo)
    _drop_set_(ls_ref, new_slot, ref_create, create_pool)

    # Cluster counts, pre-aggregated the same way
    seg_add_n = _segment_sum(torch.where(committed, row_n[aorder], 0), agrp, m)[agrp_l]
    _drop_add_(n, best_s, seg_add_n, seg_any)
    _drop_add_(n, new_slot, pool_created_n, create_commit)


def _launch(*args) -> None:
    global launches
    if any(t is None for t in args):
        raise ValueError("commit-writes kernel: every tensor is needed on the card")
    ls, t_pk, t_pops, t_slot, ls_ref, n, group, pos, row_ls, row_pk, gj_ls = args[:11]
    if row_ls.dim() != 2 or ls.dim() != 2 or t_pk.dim() != 3:
        raise ValueError("commit-writes kernel: row_ls and ls must be 2-d, t_pk 3-d")
    m, f = row_ls.shape
    f8 = (f + 7) // 8
    g_cap, fc, _ = t_pk.shape
    c_cap = group.shape[0]
    rows = dict(zip(_ROW_INPUTS, args[11:]))
    dev = kernel.check(
        {
            "ls": (ls, _I32, (ls.shape[0], f)),
            "t_pk": (t_pk, torch.uint8, (g_cap, fc, f8)),
            "t_pops": (t_pops, _I32, (g_cap, fc)),
            "t_slot": (t_slot, _I32, (g_cap, fc)),
            "ls_ref": (ls_ref, _I32, (c_cap,)),
            "n": (n, _I32, (c_cap,)),
            "group": (group, _I32, (c_cap,)),
            "pos": (pos, _I32, (c_cap,)),
            "row_ls": (row_ls, _I32, (m, f)),
            "row_pk": (row_pk, torch.uint8, (m, f8)),
            "gj_ls": (gj_ls, _I32, (m, f)),
            **{k: (t, _ROW_INPUTS[k], (m,)) for k, t in rows.items()},
        },
    )
    if m == 0 or f == 0 or min(ls.shape[0], g_cap, fc, c_cap) == 0:
        return  # nothing can be written: no launch
    # Each segment's writer position; the kernel reads an entry only where
    # it names a writer of that segment, so it needs no reset
    seg_writer = torch.empty((m,), dtype=_I32, device=dev)
    kernel.launch(
        "bb_commit_writes", dev, ls, t_pk, t_pops, t_slot, ls_ref, n, group, pos,
        row_ls, row_pk, gj_ls, *rows.values(), seg_writer,
        m, f, ls.shape[0], g_cap, fc, c_cap,
    )
    launches += 1


def commit_writes(
    ls: torch.Tensor,  # (P_cap, F) int32 pool, in place
    t_pk: torch.Tensor,  # (G_cap, Fc, F8) uint8 tiles, in place
    t_pops: torch.Tensor,  # (G_cap, Fc) int32, in place
    t_slot: torch.Tensor,  # (G_cap, Fc) int32, in place
    ls_ref: torch.Tensor,  # (C_cap,) int32, in place
    n: torch.Tensor,  # (C_cap,) int32, in place
    group: torch.Tensor,  # (C_cap,) int32
    pos: torch.Tensor,  # (C_cap,) int32
    row_ls: torch.Tensor,  # (M, F) int32, row order
    row_pk: torch.Tensor,  # (M, F8) uint8, row order
    gj_ls: torch.Tensor,  # (M, F) int32 joint creations' sums by segment
    row_single: torch.Tensor,  # (M,) bool: row_ls is the bits of row_pk
    row_n: torch.Tensor,  # (M,) int32
    aorder: torch.Tensor,  # (M,) int64 sorted -> row
    agrp: torch.Tensor,  # (M,) int32 segment of each sorted position
    committed: torch.Tensor,  # (M,) bool, sorted
    seg_any: torch.Tensor,  # (M,) bool, sorted
    promo: torch.Tensor,  # (M,) bool, sorted
    adder: torch.Tensor,  # (M,) bool, sorted
    ref_promo: torch.Tensor,  # (M,) int32, sorted
    cand_ref: torch.Tensor,  # (M,) int32, sorted
    best_s: torch.Tensor,  # (M,) int32, sorted
    jseg: torch.Tensor,  # (M,) int32 row -> gj_ls row
    join_ok: torch.Tensor,  # (M,) bool
    fits: torch.Tensor,  # (M,) bool
    create_pool: torch.Tensor,  # (M,) bool
    ref_create: torch.Tensor,  # (M,) int32
    create_commit: torch.Tensor,  # (M,) bool
    created_n: torch.Tensor,  # (M,) int32
    pool_created_n: torch.Tensor,  # (M,) int32
    cell: torch.Tensor,  # (M,) int32
    new_slot: torch.Tensor,  # (M,) int32
) -> None:
    r"""Write the round's pool rows, pool refs, cluster counts and tile
    cells (the module's contract) into ``ls``, ``ls_ref``, ``n``, ``t_pk``,
    ``t_pops`` and ``t_slot`` in place.

    Replaces ``bblean_tpu/engine/batch.py:572-579``, ``:660-684`` and
    ``:686-736``.  On the card one call of ``bb_commit_writes``
    (``csrc/commit_writes.cu``); on the CPU :func:`commit_writes_plain`.
    """
    args = (
        ls, t_pk, t_pops, t_slot, ls_ref, n, group, pos, row_ls, row_pk, gj_ls,
        row_single, row_n, aorder, agrp, committed, seg_any, promo, adder, ref_promo,
        cand_ref, best_s, jseg, join_ok, fits, create_pool, ref_create, create_commit,
        created_n, pool_created_n, cell, new_slot,
    )
    if ls.device.type == "cpu":
        return commit_writes_plain(*args)
    return _launch(*args)
