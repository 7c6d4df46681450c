r"""Level-synchronous batched BitBirch engine on PyTorch (CPU or CUDA).

Port of ``bblean_tpu/engine/batch.py``: the fit path, buffer mode
(pre-aggregated CF rows), refinement, reclustering, extraction and the
nearest-cluster probe (``predict_packed``).  The CF-tree is flattened
to depth 2 and stored as flat device tables (see :class:`BatchState`):

- **groups**: a routing table of group majority centroids ``(G, F) int8``
  searched with an int8 matrix product per step, plus group CF aggregates;
- **clusters**: a flat count table plus a sparse linear-sum pool (only
  multi-member clusters own an ``(F,) int32`` pool row) and per-group
  packed-centroid tiles ``(G, Fc, F/8) uint8``, which the in-group search
  scores with AND + popcount (the CUDA kernels of
  ``bblean_tpu_torch/ops/tile_search.py`` on the card).

Each batch step routes every row to a group once, then runs insert rounds:
search the routed tile, test the merge criterion, commit serial-prefix
segments per candidate cluster, elect leaders among rejected rows for new
clusters, scatter the results.  Rows that exhaust ``max_rounds`` go back to
the host driver, which splits oversized groups and retries them.

Differences from the JAX engine.  Only the first can change a label, and
only where a cluster's sums pass 2^24 (tests hold the rest to JAX exactly):

- iSIM is the correctly rounded f32 value of exact integer sums
  (``ops/isim.py``); JAX's f32 reduction gives the same value wherever its
  steps are exact and a backend-dependent one past 2^24.
- The JAX ``while_loop`` conditions, the per-batch split ``lax.cond`` and
  the route's live-block count become scalar reads on the host (counted in
  :data:`host_syncs`); the ``lax.scan`` over a window's batches becomes a
  Python loop, and all-padding batches of a window skip their step (it
  would commit nothing).
- JAX compiles the step into one program; here each insert round and each
  split pass is one program of ``engine/graphs.py``, a CUDA graph on the
  card replayed once per round, while the route, the sort plan and the
  refresh are dispatched once per step.  JAX's step-constant row Gram
  (``row_sims``) has no counterpart: the leader election computes the
  sims of the pairs it needs from the packed rows.
- JAX donated the state to its jitted steps; here the step functions
  update the state's tables IN PLACE and return the state with its new
  counters.  Callers that need the old tables must copy them first.
- JAX scatters with ``mode="drop"`` to an out-of-bounds index.  torch has no
  drop mode, so masked rows are sent to the table's top slot, which the
  host keeps free as a guard (``_ensure_capacity``), and write back the
  guard's own value (``_drop_set_``) or add zero (``_drop_add_``).  This
  needs no device-to-host sync.
- A split pass never opens a group past the group table's guard slot; the
  split waits for the host to grow the table.  The JAX engine opens it,
  drops its table writes and reads clamped rows after; that happens only
  when the scan window's group headroom is disabled, as
  ``tests/test_pool_telemetry.py`` does, and there the two engines' labels
  part (``tests/test_torch_pool_telemetry.py`` shows JAX's ``g_num`` passing
  its table and clusters left outside their tiles).
- Which search runs where (``ops/tile_search.py``; on the card a CUDA
  kernel, on the CPU the one plain version): the wide rounds of a step run
  the sorted search on the step's plan; the narrow retry rounds run the
  per-row search, as the JAX engine runs ``_search_tiles`` there; predict
  runs the sorted search where JAX would take its sorted Pallas search
  (``m % 64 == 0``, ``F8 % 128 == 0``, ``Fc % 128 == 0``) and the per-row
  search elsewhere.  The TPU engine kept its Pallas searches opt-in.
"""

from __future__ import annotations

import functools
import time
import typing as tp
from pathlib import Path

import numpy as np
import torch

from bblean_tpu_torch.engine import graphs, spans
from bblean_tpu_torch.ops.isim import majority_centroid_from_sums
from bblean_tpu_torch.ops.merges import merge_accept_batch, merge_accept_from_moments
from bblean_tpu_torch.ops.prefix_commit import prefix_commit_moments
from bblean_tpu_torch.ops.commit_writes import commit_writes
from bblean_tpu_torch.ops.leader_election import elect_leaders
from bblean_tpu_torch.ops.packing import (
    pack_fingerprints_device,
    unpack_fingerprints_device,
)
from bblean_tpu_torch.ops import refresh, route, tile_search
from bblean_tpu_torch.ops.popcount import _popcount_u8
from bblean_tpu_torch.ops.segments import (
    _BIG,
    _drop_add_,
    _drop_set_,
    _group_ids_by_key,
    _icumsum,
    _isum,
    _segment_max,
    _segment_min,
    _segment_sum,
)
from bblean_tpu_torch.ops.tile_search import (
    sorted_search_plan,
    tile_search_planned,
    tile_search_rows,
    tile_search_sorted,
)

__all__ = ["BatchTree", "BatchState"]

_I32 = torch.int32
# Routing/row centroids are exactly 0/1 valued, so int8 products with int32
# accumulation are exact
_CENT_DT = torch.int8

# Device-to-host scalar reads made by the engine (round-loop conditions,
# split predicates, live-group counts, flush-boundary pulls)
host_syncs = 0

# Refinements run (``BatchTree.refine_inplace``), the CF buffer rows (one a
# surviving cluster) and exploded fingerprint rows they inserted, and the
# host wall in ns of their three stages: the order, the members, the
# survivors gathered on the device and the tree reset; the survivors' batch
# steps; the exploded rows loaded and fitted
refine_calls = 0
refine_buffer_rows = 0
refine_exploded_rows = 0
refine_extract_ns = 0
refine_buffers_ns = 0
refine_rows_ns = 0
# Buffer rows assembled on the device from a tree's own tables (a refine's
# survivors, a recluster's clusters); a user's ``insert_buffers`` adds none
refine_device_buffer_rows = 0


def _host(t: torch.Tensor) -> np.ndarray:
    global host_syncs
    host_syncs += 1
    with spans.span("sync"):
        return t.cpu().numpy()


def _host_int(t: torch.Tensor) -> int:
    return int(_host(t))


class BatchState(tp.NamedTuple):
    r"""Device-side depth-2 CF-tree (capacity-padded flat tables); the same
    fields, shapes and dtypes as the JAX engine's ``BatchState``.

    The top slot of the cluster, group and pool tables is a guard: the host
    never lets a live entry reach it, masked scatters park there, and the
    guard group's tile holds no live cell.
    """

    # Sparse linear-sum pool (multi-member clusters only)
    ls: torch.Tensor  # (P_cap, F) int32 linear sums
    num_ls: torch.Tensor  # () int32 allocated pool rows
    # Leaf clusters (flat)
    ls_ref: torch.Tensor  # (C_cap,) int32 pool row per slot, -1 = singleton
    n: torch.Tensor  # (C_cap,) int32 sizes (0 = empty slot)
    group: torch.Tensor  # (C_cap,) int32 owning group id
    pos: torch.Tensor  # (C_cap,) int32 position within the group tile
    num: torch.Tensor  # () int32 live clusters
    # Per-group packed-centroid tiles (the in-group search set)
    t_pk: torch.Tensor  # (G_cap, Fc, F8) uint8 packed centroids
    t_pops: torch.Tensor  # (G_cap, Fc) int32 centroid popcounts
    t_slot: torch.Tensor  # (G_cap, Fc) int32 cluster slot per cell (-1 empty)
    # Groups (routing level)
    g_ls: torch.Tensor  # (G_cap, F) int32
    g_n: torch.Tensor  # (G_cap,) int32 samples under the group
    g_cent: torch.Tensor  # (G_cap, F) int8 routing centroids (0/1 values)
    g_pops: torch.Tensor  # (G_cap,) int32
    g_count: torch.Tensor  # (G_cap,) int32 clusters in the group
    g_num: torch.Tensor  # () int32 live groups


# The three counters of a state, and its tables (every other field, in
# field order): a graphed program reads its counters from static buffers
# and its tables by address (``engine/graphs.py``)
_COUNTERS = ("num_ls", "num", "g_num")
_TABLES = tuple(f for f in BatchState._fields if f not in _COUNTERS)


def _tables(state: BatchState) -> tuple[torch.Tensor, ...]:
    return tuple(getattr(state, f) for f in _TABLES)


def _state_of(tables: tuple, bufs: graphs.Buffers) -> BatchState:
    r"""The state a program sees: ``tables`` and the counters in ``bufs``
    (None where the program keeps none)."""
    return BatchState(**dict(zip(_TABLES, tables)), **{c: bufs.get(c) for c in _COUNTERS})


def _init_state(
    capacity: int,
    g_capacity: int,
    tile: int,
    n_features: int,
    ls_capacity: int | None = None,
    device: str | torch.device = "cpu",
) -> BatchState:
    f8 = (n_features + 7) // 8
    if ls_capacity is None:
        ls_capacity = capacity

    def z(*shape, dtype=_I32):
        return torch.zeros(shape, dtype=dtype, device=device)

    def full(shape, value):
        return torch.full(shape, value, dtype=_I32, device=device)

    return BatchState(
        ls=z(ls_capacity, n_features),
        num_ls=z(),
        ls_ref=full((capacity,), -1),
        n=z(capacity),
        group=z(capacity),
        pos=z(capacity),
        num=z(),
        t_pk=z(g_capacity, tile, f8, dtype=torch.uint8),
        t_pops=z(g_capacity, tile),
        t_slot=full((g_capacity, tile), -1),
        g_ls=z(g_capacity, n_features),
        g_n=z(g_capacity),
        g_cent=z(g_capacity, n_features, dtype=_CENT_DT),
        g_pops=z(g_capacity),
        g_count=z(g_capacity),
        g_num=torch.ones((), dtype=_I32, device=device),  # group 0 exists
    )


def _cluster_ls_of(
    state: BatchState, slots: torch.Tensor, n_features: int
) -> torch.Tensor:
    r"""(M, F) int32 linear sums of cluster ``slots``: the pool row when
    allocated, else the exact singleton bits from the packed tile entry."""
    slots = slots.long()
    pk = state.t_pk[state.group[slots].long(), state.pos[slots].long()]
    return _ls_rows(state.ls_ref[slots], state.ls, pk, n_features)


def _ls_rows(
    ref: torch.Tensor, pool: torch.Tensor, pk: torch.Tensor, n_features: int
) -> torch.Tensor:
    r"""(M, F) int32 rows: ``pool[ref]`` where ``ref >= 0``, else the bits
    of the packed rows ``pk``."""
    pool_rows = pool[ref.clamp_min(0).long()]
    bits = unpack_fingerprints_device(pk, n_features).to(_I32)
    return torch.where((ref >= 0)[:, None], pool_rows, bits)


class _Survivors:
    r"""Clusters that re-enter a reset tree whole, one CF buffer row each,
    gathered on the device from the old tables before they are dropped.

    In entry order: counts ``n``; ``ref``, the row of ``ls`` that holds
    the sums where the cluster had a pool row (``ls_ref >= 0``, as
    :func:`_cluster_ls_of` decides, whatever the count), else -1; ``bit``,
    the row of ``pk`` that holds the packed tile bits of the others (0 for
    the pooled).  On the host: the counts (``sizes``) and the members as
    one flat id array (``mols``) with the ``R + 1`` offsets that bound
    each row's ids (``bounds``)."""

    def __init__(
        self,
        state: BatchState,
        order: np.ndarray,
        sizes: np.ndarray,
        mols: np.ndarray,
        bounds: np.ndarray,
    ) -> None:
        slots = torch.from_numpy(order).to(state.n.device)
        ref = state.ls_ref[slots]
        pooled = ref >= 0
        self.n = state.n[slots]
        self.ref = torch.where(pooled, torch.cumsum(pooled, 0) - 1, -1)
        self.bit = torch.where(pooled, 0, torch.cumsum(~pooled, 0) - 1)
        loose = slots[~pooled]
        self.ls = _at_least_one_row(state.ls[ref[pooled].long()])
        self.pk = _at_least_one_row(
            state.t_pk[state.group[loose].long(), state.pos[loose].long()]
        )
        self.sizes, self.mols, self.bounds = sizes[order], mols, bounds

    def __len__(self) -> int:
        return len(self.sizes)

    def batch(
        self, start: int, m: int, n_features: int
    ) -> tuple[tuple[torch.Tensor, ...], tuple[np.ndarray, np.ndarray], np.ndarray]:
        r"""Rows ``[start, start + m)`` as one batch step's rows (zero rows
        of count 0 past the end), their members and the host's mask of
        rows to insert."""
        stop = min(start + m, len(self))
        row_ls = _ls_rows(
            self.ref[start:stop], self.ls, self.pk[self.bit[start:stop]], n_features
        )
        rows = _prep_buffer_rows(_pad_rows(row_ls, m), _pad_rows(self.n[start:stop], m))
        bounds = self.bounds[start : stop + 1]
        mols = (self.mols[bounds[0] : bounds[-1]], np.diff(bounds))
        host_valid = np.zeros(m, bool)
        host_valid[: stop - start] = self.sizes[start:stop] > 0
        return rows, mols, host_valid

    def drop(self) -> None:
        r"""Free the device store."""
        self.n = self.ref = self.bit = self.ls = self.pk = None


def _at_least_one_row(t: torch.Tensor) -> torch.Tensor:
    r"""``t``, or one zero row where it has none (a gather's target)."""
    return t if len(t) else t.new_zeros((1, *t.shape[1:]))


def _regroup(
    flat: np.ndarray, bounds: np.ndarray, order: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    r"""Members of clusters ``order`` (slot ids into the CSR ``flat`` /
    ``bounds``), one after another: the flat ids and their own offsets."""
    starts = bounds[order]
    lens = bounds[order + 1] - starts
    new_bounds = np.concatenate([[0], np.cumsum(lens)])
    take = np.arange(new_bounds[-1]) + np.repeat(starts - new_bounds[:-1], lens)
    return flat[take], new_bounds


def _pad_rows(t: torch.Tensor, rows: int, fill: int = 0) -> torch.Tensor:
    extra = rows - t.shape[0]
    if extra <= 0:
        return t
    pad = torch.full((extra, *t.shape[1:]), fill, dtype=t.dtype, device=t.device)
    return torch.cat([t, pad])


def _grow_state(
    state: BatchState, new_c: int, new_g: int, new_p: int | None = None
) -> BatchState:
    p_rows = new_p if new_p is not None else state.ls.shape[0]
    return BatchState(
        ls=_pad_rows(state.ls, p_rows),
        num_ls=state.num_ls,
        ls_ref=_pad_rows(state.ls_ref, new_c, -1),
        n=_pad_rows(state.n, new_c),
        group=_pad_rows(state.group, new_c),
        pos=_pad_rows(state.pos, new_c),
        num=state.num,
        t_pk=_pad_rows(state.t_pk, new_g),
        t_pops=_pad_rows(state.t_pops, new_g),
        t_slot=_pad_rows(state.t_slot, new_g, -1),
        g_ls=_pad_rows(state.g_ls, new_g),
        g_n=_pad_rows(state.g_n, new_g),
        g_cent=_pad_rows(state.g_cent, new_g),
        g_pops=_pad_rows(state.g_pops, new_g),
        g_count=_pad_rows(state.g_count, new_g),
        g_num=state.g_num,
    )


def _route_groups(
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
    better): ``ops/route.py::route_groups``, the CUDA kernel on the card."""
    return route.route_groups(row_cent, row_pop, g_cent, g_pops, g_num, pending, block)


def _segment_rank(grp: torch.Tensor, mask_sorted: torch.Tensor) -> torch.Tensor:
    r"""Rank of each (sorted) row within its segment, counting masked rows."""
    inc = mask_sorted.to(_I32)
    csum = _icumsum(inc)
    seg_start_csum = _segment_min(csum - inc, grp, grp.shape[0])
    return csum - inc - seg_start_csum[grp.long()]


def _prefix_counts(
    inc: torch.Tensor, row_n_s: torch.Tensor, cand_n_s: torch.Tensor, seg_start: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    r"""(merged, pre-merge, nominee) counts of each sorted row's merge test
    in a prefix commit: its candidate's count plus the included rows'
    counts before it in its segment, and its own where ``inc``."""
    s_n = torch.where(inc, row_n_s, 0)
    excl_n = _icumsum(s_n) - s_n
    old_n = cand_n_s + (excl_n - excl_n[seg_start])
    return old_n + s_n, old_n, s_n


def _scatter_perm(order: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    r"""``out[order] = vals`` for a permutation ``order`` (a fresh tensor)."""
    out = torch.empty_like(vals)
    out[order] = vals
    return out


class _Stages:
    r"""The stage boundaries of an insert round, one stage open at a time:
    ``stage(name)`` ends the open stage and starts the next, ``stage.end()``
    ends it.  While spans are recorded (``engine/spans.py``) each stage of
    a dispatched round is a ``round.<name>`` span; a captured round records
    none (its Python runs once, to capture) and a replayed one runs no
    Python.  ``chip_ab.py --rounds`` replaces the class with one that
    launches a marker kernel at each boundary, to split a dispatched
    round's device time by stage."""

    def __init__(self) -> None:
        self._open = None

    def __call__(self, name: str) -> None:
        self.end()
        if spans.on and graphs.capturing is None:
            self._open = spans.span(f"round.{name}")
            self._open.__enter__()

    def end(self) -> None:
        if self._open is not None:
            self._open.__exit__(None, None, None)
            self._open = None


# The stages of an insert round, in order
ROUND_STAGES = (
    "search", "screen", "commits", "election", "cohesion", "create guard",
    "positions", "tables", "tile writes", "pool writes",
)


def _insert_round(
    state: BatchState,
    pending: torch.Tensor,
    assigned: torch.Tensor,
    strikes: torch.Tensor,
    row_group: torch.Tensor,
    row_ls: torch.Tensor,
    row_n: torch.Tensor,
    row_cent: torch.Tensor,
    row_pk: torch.Tensor,
    row_pop: torch.Tensor,
    row_single: torch.Tensor,
    threshold: torch.Tensor,
    tolerance: torch.Tensor,
    *,
    criterion: str,
    search_plan: tuple[torch.Tensor, ...] | None = None,
    election_plan: tuple[torch.Tensor, ...] | None = None,
) -> tuple[BatchState, torch.Tensor, torch.Tensor, torch.Tensor]:
    r"""One insertion round over a row window of any width.

    Every computation is masked by ``pending`` and depends on rows only
    through their relative order, so a round over a compacted subset of the
    rows commits exactly what the full-width round would (what makes the
    narrow retry rounds label-preserving).  ``row_group`` is the per-row
    routed group, computed once per step; the leader election computes its
    pairs' sims from the packed rows in-round (JAX's ``row_sims``, the
    step's all-pairs row Tanimoto, has no counterpart here).
    ``search_plan`` is the step's sort plan ``(rows, pops, keys, order,
    items)`` for the sorted search; None runs the per-row search (no sort).
    The leader election lists the rejected rows by group through the
    step's plan: ``(order, keys)`` of ``search_plan``, else
    ``election_plan``, ``(order, keys, sel)`` of a round over the step's
    rows ``sel`` (``ops/leader_election.py``; the CPU ignores it).
    ``row_single`` marks the rows whose sums are the bits of ``row_pk``
    (set by the step's row producers; the writes' kernel reads those rows
    packed).

    Updates the state's tables in place; returns (state with its new
    counters, pending, assigned, strikes).
    """
    m, n_features = row_ls.shape
    dev = row_ls.device
    tile = state.t_pk.shape[1]
    row_idx = torch.arange(m, dtype=_I32, device=dev)
    force_lead = strikes >= 2
    stage = _Stages()

    # ---- 2. in-group candidate search (sorted on a plan, else per row) ----
    stage("search")
    if search_plan is not None:
        srows, spops, skey, order, items = search_plan
        best_sim, best = tile_search_planned(
            srows, spops, skey, order, state.t_pk, state.t_pops,
            state.t_slot, pending, items,
        )
    else:
        best_sim, best = tile_search_rows(
            row_pk, row_pop, row_group, state.t_pk, state.t_pops,
            state.t_slot, pending,
        )
    has_cand = best_sim > -1.5
    best_l = best.long()

    # ---- 3. individual merge evaluation (ops/prefix_commit.py: every row
    # its own segment, nothing before it) ----
    stage("screen")
    cand_ls = _cluster_ls_of(state, best_l, n_features)
    cand_n = state.n[best_l]
    cand_ref = state.ls_ref[best_l]
    merged_n = cand_n + row_n
    # Rows that repeatedly pass the individual screen but lose the commit
    # prefix are demoted to the rejected path; the screen's result is kept
    # for these rows only, so the kernel reads no others
    screened = pending & has_cand & (strikes < 2)
    accept = merge_accept_from_moments(
        criterion, threshold,
        prefix_commit_moments(criterion, row_ls, cand_ls, merged_n, cand_n, need=screened),
        merged_n, cand_n, row_n, tolerance=tolerance,
    )
    accept = accept & screened

    # ---- conflict resolution: serial prefix commits per candidate ----
    stage("commits")
    akey = torch.where(accept, best, _BIG)
    aorder, agrp, astart = _group_ids_by_key(akey)
    a_ok = accept[aorder]
    row_n_a = row_n[aorder]
    cand_n_s = cand_n[aorder]
    # Per-row index of its segment's first sorted position
    seg_start = torch.cummax(torch.where(astart, row_idx, 0), dim=0).values.long()

    def commit_pass(inc: torch.Tensor) -> torch.Tensor:
        r"""Each included sorted row's merge test against its candidate plus
        the included rows before it in its segment; the (M, F) prefix sums
        stay inside ``prefix_commit_moments`` (one kernel on the card), and
        only the included rows' results are kept (``need``)."""
        new_n, old_n, s_n = _prefix_counts(inc, row_n_a, cand_n_s, seg_start)
        moments = prefix_commit_moments(
            criterion, row_ls, cand_ls, new_n, old_n, order=aorder, mask=inc,
            seg_start=seg_start, need=inc,
        )
        return merge_accept_from_moments(
            criterion, threshold, moments, new_n, old_n, s_n, tolerance=tolerance,
        ) & inc

    acc_pref = commit_pass(a_ok)
    # ---- pass 2: skip failed rows and re-validate (serial semantics: a
    # failed row adds no mass to later rows' tests); commit the longest
    # prefix of surviving rows whose every cumulative merge holds ----
    inc2 = acc_pref
    acc2 = commit_pass(inc2)
    acc2_i = acc2.to(_I32)
    inc2_i = inc2.to(_I32)
    acc2_cum = _icumsum(acc2_i)
    inc2_cum = _icumsum(inc2_i)
    acc2_run = acc2_cum - (acc2_cum - acc2_i)[seg_start]
    inc2_run = inc2_cum - (inc2_cum - inc2_i)[seg_start]
    committed_sorted = acc2 & (acc2_run == inc2_run)

    # ---- pool-capacity guard (merge side): a promotion (a singleton
    # candidate's first merge) allocates a pool row; when the pool is full
    # the allocating segment rolls back whole and its rows pend ----
    p_cap = state.ls.shape[0]
    cand_ref_s = cand_ref[aorder]
    cmt_i = committed_sorted.to(_I32)
    cmt_cum = _icumsum(cmt_i)
    cmt_run = cmt_cum - (cmt_cum - cmt_i)[seg_start]
    seg_any = committed_sorted & (cmt_run == 1)
    promo_try = seg_any & (cand_ref_s < 0)
    ref_promo_sorted = state.num_ls + _icumsum(promo_try.to(_I32)) - 1
    promo_ok = ~promo_try | (ref_promo_sorted < p_cap - 1)
    seg_ok = _segment_min(promo_ok.to(_I32), agrp, m)[agrp.long()].to(torch.bool)
    committed_sorted = committed_sorted & seg_ok
    seg_any = seg_any & seg_ok
    # One writer per surviving segment: promotions allocate, adders add
    promo_sorted = promo_try & seg_ok
    adder_sorted = seg_any & (cand_ref_s >= 0)
    n_promo = _isum(promo_sorted)
    merge_commit = _scatter_perm(aorder, committed_sorted)

    # ---- 4. leader election among rejected rows (per routed group) ----
    stage("election")
    rejected = pending & ~accept
    if criterion == "never-merge":
        leader = rejected
        join = torch.zeros((m,), dtype=torch.bool, device=dev)
        lead_of = row_idx
    else:
        # ops/leader_election.py: the pairs of rejected rows of one routed
        # group, their sims from the packed rows, listed through the step's
        # sort plan (every pending row sits in its group's segment there);
        # lead_of and best_lead_sim hold on the rejected rows that do not
        # lead, the only ones read below
        leads, lead_of, best_lead_sim = elect_leaders(
            rejected, force_lead, row_group, threshold, row_pk=row_pk, row_pop=row_pop,
            plan=election_plan if search_plan is None else (search_plan[3], search_plan[2]),
        )
        join = rejected & ~leads & (best_lead_sim >= threshold)
        leader = leads
        lead_of = torch.where(leader, row_idx, lead_of)
    lead_of_l = lead_of.long()

    # Cohesion check of each leader's would-be cluster
    stage("cohesion")
    jkey = torch.where(leader | join, lead_of, _BIG)
    jorder, jgrp, _jstart = _group_ids_by_key(jkey)
    jgrp_l = jgrp.long()
    j_ok = (leader | join)[jorder]
    j_ls = torch.where(j_ok[:, None], row_ls[jorder], 0)
    j_n = torch.where(j_ok, row_n[jorder], 0)
    gj_ls = _segment_sum(j_ls, jgrp, m)
    gj_n = _segment_sum(j_n, jgrp, m)
    del j_ls
    gj_ok = merge_accept_batch(
        criterion, threshold, gj_ls, gj_n.clamp_min(2),
        torch.zeros_like(gj_ls), torch.ones_like(gj_n), gj_n,
        tolerance=tolerance,
    ) | (gj_n <= 1)
    join_ok = _scatter_perm(jorder, gj_ok[jgrp_l])
    join_commit = join & join_ok
    # Followers of a non-cohesive would-be cluster become creators now
    creator = leader | (join & ~join_ok)

    # ---- pool-capacity guard (create side); runs before tile positions
    # are ranked so that a dropped creator leaves no hole in its tile ----
    stage("create guard")
    # Each row's cohesion segment: its sums are gj_ls[jseg] (read by
    # ops/commit_writes.py, not spread to an (M, F) plane)
    jseg = _scatter_perm(jorder, jgrp)
    gj_full_n = gj_n[jseg.long()]
    pool_created_n = torch.where(join_ok, gj_full_n, row_n)
    create_pool_try = creator & (pool_created_n >= 2)
    ref_create = state.num_ls + n_promo + _icumsum(create_pool_try.to(_I32)) - 1
    create_ok = ~create_pool_try | (ref_create < p_cap - 1)
    creator = creator & create_ok
    join_commit = join_commit & create_ok[lead_of_l]

    # ---- 5. tile positions for new clusters (per group, index order);
    # creations into full tiles open fresh overflow groups, packed densely
    # in chunks of `tile` per routed group ----
    stage("positions")
    ckey = torch.where(creator, row_group, _BIG)
    corder, cgrp, _cstart = _group_ids_by_key(ckey)
    crank = _scatter_perm(corder, _segment_rank(cgrp, creator[corder]))
    new_pos = state.g_count[row_group.long()] + crank
    chunk = torch.div(new_pos, tile, rounding_mode="floor")
    chunk_sorted = torch.where(creator[corder], chunk[corder], 0)
    # segment_max fills EMPTY segments with int32-min: clamp to 0
    seg_new = _segment_max(chunk_sorted, cgrp, m).clamp_min(0)
    seg_base = _icumsum(seg_new) - seg_new
    seg_of_row = _scatter_perm(corder, cgrp)
    over_group = state.g_num + seg_base[seg_of_row.long()] + (chunk - 1)
    fits = chunk == 0
    # Rows whose overflow group would exceed capacity pend (a rank suffix
    # per routed-group segment, so survivors' positions stay contiguous)
    g_cap = state.g_ls.shape[0]
    fits_g = fits | (over_group < g_cap - 1)
    tgt_group = torch.where(fits, row_group, over_group)
    tgt_pos = torch.where(fits, new_pos, torch.remainder(new_pos, tile))
    create_commit = creator & fits_g
    join_commit = join_commit & fits_g[lead_of_l]
    # Pool refs of fits_g-killed multi-member creators stay consumed
    create_pool = create_pool_try & create_ok & fits_g

    lead_rank = _icumsum(create_commit.to(_I32)) - 1
    new_slot = state.num + lead_rank
    slot_of_row = torch.where(
        merge_commit,
        best,
        torch.where(
            create_commit,
            new_slot,
            torch.where(join_commit, new_slot[lead_of_l], -1),
        ),
    )
    commit = merge_commit | create_commit | join_commit

    # ---- 6. commit the flat cluster tables (in place) ----
    stage("tables")
    num = state.num + _isum(create_commit)
    g_num = torch.clamp_max(state.g_num + _isum(seg_new), g_cap - 1)
    _drop_set_(state.group, new_slot, tgt_group, create_commit)
    _drop_set_(state.pos, new_slot, tgt_pos, create_commit)
    _drop_add_(
        state.g_count, tgt_group, torch.ones_like(tgt_group), create_commit
    )

    # ---- 7. tile entries for CREATED clusters (merged clusters keep a
    # slightly stale tile centroid until the step's refresh) ----
    stage("tile writes")
    created_n = torch.where(join_ok & fits, gj_full_n, row_n)
    cell = tgt_group * tile + tgt_pos

    # ---- 8. sparse linear-sum pool: promotions (old bits + this round's
    # committed rows) and multi-member creations, their pool refs, and the
    # cluster counts; merge updates are pre-aggregated per candidate
    # segment (one writer row each).  With step 7's tile cells, written by
    # ops/commit_writes.py (one kernel on the card) ----
    stage("pool writes")
    commit_writes(
        state.ls, state.t_pk, state.t_pops, state.t_slot, state.ls_ref, state.n,
        state.group, state.pos, row_ls, row_pk, gj_ls, row_single, row_n, aorder, agrp,
        committed_sorted, seg_any, promo_sorted, adder_sorted, ref_promo_sorted,
        cand_ref_s, best[aorder], jseg, join_ok, fits, create_pool, ref_create,
        create_commit, created_n, pool_created_n, cell, new_slot,
    )
    del gj_ls
    num_ls = state.num_ls + n_promo + _isum(create_pool_try & create_ok)

    assigned = torch.where(commit, slot_of_row, assigned)
    pending = pending & ~commit
    struck = pending & (
        (accept & ~merge_commit)
        | (join & ~join_commit)
        | (leader & ~create_commit)
    )
    strikes = torch.where(pending, strikes + struck.to(_I32), 0)
    stage.end()
    return state._replace(num_ls=num_ls, num=num, g_num=g_num), pending, assigned, strikes


@spans.spanned("step")
def _batch_step_impl(
    state: BatchState,
    row_ls: torch.Tensor,  # (M, F) int32
    row_n: torch.Tensor,  # (M,) int32 (0 rows are padding)
    row_cent: torch.Tensor,  # (M, F) int8 (0/1 values)
    row_pk: torch.Tensor,  # (M, F8) uint8 packed centroid
    row_pop: torch.Tensor,  # (M,) int32
    row_single: torch.Tensor,  # (M,) bool: row_ls is the bits of row_pk
    threshold: torch.Tensor,  # () f32
    tolerance: torch.Tensor,  # () f32
    *,
    criterion: str,
    block: int,
    max_rounds: int,
    narrow: int = 0,
) -> tuple[BatchState, torch.Tensor, torch.Tensor]:
    r"""Insert one batch of CF rows.

    Returns (state, assigned slot per row, pending * 1000 + rounds);
    assigned == -1 marks rows the host must retry after splitting oversized
    groups.  Rounds run full-width while more than ``narrow`` rows are
    pending, then as compacted rounds over the ``narrow`` lowest-index
    pending rows (label-preserving, see ``_insert_round``); ``narrow=0``
    disables the narrow phase.  Each round's loop condition is one scalar
    read on the host.

    Each round is a program of ``engine/graphs.py`` (a CUDA graph on the
    card: :func:`_wide_round`, :func:`_narrow_round`).  The step writes its
    inputs into the programs' static buffers once (:func:`_stage_step`),
    the rounds carry their state there, and the step hands out copies.
    """
    m = row_ls.shape[0]
    bufs = _stage_step(
        state, row_ls, row_n, row_cent, row_pk, row_pop, row_single, threshold,
        tolerance, block=block,
    )
    tables = _tables(state)
    wide = functools.partial(_wide_round, criterion=criterion)
    rounds = 0
    limit = narrow if 0 < narrow < m else 0
    while rounds < max_rounds and _host_int(_isum(bufs["pending"])) > limit:
        _carry(bufs, graphs.run(("wide", criterion), wide, tables, bufs))
        rounds += 1

    if 0 < narrow < m:
        compact = functools.partial(_narrow_round, criterion=criterion, narrow=narrow)
        while rounds < max_rounds and bool(_host(bufs["pending"].any())):
            _carry(bufs, graphs.run(("narrow", criterion, narrow), compact, tables, bufs))
            rounds += 1

    with spans.span("refresh"):
        state = state._replace(**{c: bufs[c].clone() for c in _COUNTERS})
        assigned = bufs["assigned"].clone()
        state = _refresh_touched(
            state, assigned, row_ls, row_n, row_pk, row_single, bufs["order"]
        )
    return state, assigned, _isum(bufs["pending"]) * 1000 + rounds


@spans.spanned("step.prep")
def _stage_step(
    state: BatchState,
    row_ls: torch.Tensor,
    row_n: torch.Tensor,
    row_cent: torch.Tensor,
    row_pk: torch.Tensor,
    row_pop: torch.Tensor,
    row_single: torch.Tensor,
    threshold: torch.Tensor,
    tolerance: torch.Tensor,
    *,
    block: int,
) -> graphs.Buffers:
    r"""A step's static buffers, filled: its rows, the step-constant work
    and the round state's start (all rows pending, none assigned, no
    strikes, the state's counters)."""
    m = row_ls.shape[0]
    # Step-constant work: the route and the search's sort plan depend only
    # on the rows and the routing table, which no round changes
    pending0 = row_n > 0
    row_group = _route_groups(
        row_cent, row_pop, state.g_cent, state.g_pops,
        _host_int(state.g_num), pending0, block,
    )
    guard_g = state.g_ls.shape[0] - 1
    order, skey, items = sorted_search_plan(
        torch.where(pending0, row_group, guard_g)
    )
    inputs = dict(
        row_ls=row_ls, row_n=row_n, row_cent=row_cent, row_pk=row_pk,
        row_pop=row_pop, row_single=row_single, threshold=threshold, tolerance=tolerance,
        row_group=row_group, srows=row_pk[order], spops=row_pop[order],
        skey=skey, order=order, items=items, pending=pending0,
        **{c: getattr(state, c) for c in _COUNTERS},
    )
    specs = {k: (v.shape, v.dtype) for k, v in inputs.items()}
    specs.update(assigned=((m,), _I32), strikes=((m,), _I32))
    bufs = graphs.buffers("step", row_ls.device, specs)
    for k, v in inputs.items():
        bufs[k].copy_(v)
    bufs["assigned"].fill_(-1)
    bufs["strikes"].zero_()
    return bufs


# What a round's program returns, in order: the carried row state and the
# state's new counters
_CARRIED = ("pending", "assigned", "strikes") + _COUNTERS
_PLAN = ("srows", "spops", "skey", "order", "items")


def _carry(bufs: graphs.Buffers, out: tuple[torch.Tensor, ...]) -> None:
    r"""Copy a round's outputs into the buffers the next round reads."""
    for name, value in zip(_CARRIED, out):
        bufs[name].copy_(value)


def _wide_round(
    tables: tuple, bufs: graphs.Buffers, *, criterion: str
) -> tuple[torch.Tensor, ...]:
    r"""One full-width round on the step's sorted search plan, as a program
    of ``engine/graphs.py``: reads the step's buffers, updates ``tables``
    in place, returns the :data:`_CARRIED` values."""
    state, pending, assigned, strikes = _insert_round(
        _state_of(tables, bufs), bufs["pending"], bufs["assigned"],
        bufs["strikes"], bufs["row_group"], bufs["row_ls"], bufs["row_n"],
        bufs["row_cent"], bufs["row_pk"], bufs["row_pop"], bufs["row_single"],
        bufs["threshold"], bufs["tolerance"], criterion=criterion,
        search_plan=tuple(bufs[k] for k in _PLAN),
    )
    return (pending, assigned, strikes) + tuple(getattr(state, c) for c in _COUNTERS)


def _narrow_round(
    tables: tuple, bufs: graphs.Buffers, *, criterion: str, narrow: int
) -> tuple[torch.Tensor, ...]:
    r"""One compacted round over the ``narrow`` lowest-index pending rows on
    the per-row search, its leader election on the step's sort plan through
    the selection, scattered back to full width; a program as
    :func:`_wide_round` is."""
    pending, assigned, strikes = bufs["pending"], bufs["assigned"], bufs["strikes"]
    # Compact the pending rows to the front (stable: original order kept,
    # which is all the round logic depends on)
    sel = torch.sort((~pending).to(torch.uint8), stable=True).indices[:narrow]
    rows = [
        bufs[k][sel]
        for k in ("row_group", "row_ls", "row_n", "row_cent", "row_pk", "row_pop", "row_single")
    ]
    state, sub_pending, sub_assigned, sub_strikes = _insert_round(
        _state_of(tables, bufs), pending[sel],
        torch.full((narrow,), -1, dtype=_I32, device=sel.device), strikes[sel],
        *rows, bufs["threshold"], bufs["tolerance"], criterion=criterion,
        election_plan=(bufs["order"], bufs["skey"], sel),
    )
    assigned = assigned.clone()
    assigned[sel] = torch.where(sub_assigned >= 0, sub_assigned, assigned[sel])
    pending = pending.clone()
    pending[sel] = sub_pending
    strikes = strikes.clone()
    strikes[sel] = sub_strikes
    return (pending, assigned, strikes) + tuple(getattr(state, c) for c in _COUNTERS)


def _refresh_touched(
    state: BatchState,
    assigned: torch.Tensor,
    row_ls: torch.Tensor,
    row_n: torch.Tensor,
    row_pk: torch.Tensor,
    row_single: torch.Tensor,
    order: torch.Tensor,
) -> BatchState:
    r"""Fold committed rows into their group CFs and refresh the tile and
    routing centroids of the clusters and groups this step touched (once
    per step): ``ops/refresh.py::refresh_touched``, two launches of one
    kernel on the card, which reads flagged rows (``row_single``) as their
    packed bytes ``row_pk`` and adds the rows in ``order`` (the step's sort
    plan).  Updates the tables in place."""
    refresh.refresh_touched(
        state.g_ls, state.g_n, state.t_pk, state.t_pops, state.g_cent, state.g_pops,
        state.ls, state.ls_ref, state.n, state.group, state.pos,
        assigned, row_ls, row_n, row_pk, row_single, order,
    )
    return state


@spans.spanned("split")
def _split_topk_impl(
    state: BatchState, *, k: int, fanout: int
) -> tuple[BatchState, torch.Tensor]:
    r"""Select the K most-populated groups and split the oversized ones.

    Returns (state, number of oversized groups remaining).  ``lax.top_k``
    takes lower indices first on ties; a stable descending sort does too.
    A split whose new group would reach the guard slot waits (it counts as
    remaining) until the host grows the group table.

    The pass is a program of ``engine/graphs.py`` (a CUDA graph on the
    card, :func:`_split_pass`) that reads ``g_num`` from a static buffer.
    """
    bufs = graphs.buffers("split", state.g_num.device, {"g_num": ((), state.g_num.dtype)})
    bufs["g_num"].copy_(state.g_num)
    split = functools.partial(_split_pass, k=k, fanout=fanout)
    g_num, n_left = graphs.run(("split", k, fanout), split, _tables(state), bufs)
    return state._replace(g_num=g_num.clone()), n_left.clone()


def _split_pass(
    tables: tuple, bufs: graphs.Buffers, *, k: int, fanout: int
) -> tuple[torch.Tensor, torch.Tensor]:
    r"""The body of :func:`_split_topk_impl`: updates ``tables`` in place,
    returns (new ``g_num``, oversized groups remaining)."""
    state = _state_of(tables, bufs)
    g_cap = state.g_count.shape[0]
    live = torch.arange(g_cap, device=state.g_count.device) < state.g_num
    counts = torch.where(live, state.g_count, 0)
    vals, gs = torch.sort(counts, descending=True, stable=True)
    vals, gs = vals[:k], gs[:k].to(_I32)
    active = vals > fanout
    active = active & (state.g_num + _icumsum(active.to(_I32)) - 1 < g_cap - 1)
    n_over = _isum(counts > fanout)
    state = _split_groups_device_impl(state, gs, active)
    return state.g_num, n_over - _isum(active)


def _split_groups_device_impl(
    state: BatchState,
    gs: torch.Tensor,  # (K,) int32 group ids to split
    active: torch.Tensor,  # (K,) bool (False = padding, no-op)
) -> BatchState:
    r"""Split K oversized groups (reference node-split semantics with a
    balanced partition): seeds are the most-dissimilar pair of member
    centroids (centroid -> fp1 -> fp2); members are ranked by
    (sim-to-fp1 - sim-to-fp2) and the top half moves to the new group.

    Everything is read from the state before any table is written; the
    writes are in place.
    """
    k = gs.shape[0]
    dev = gs.device
    tile = state.t_pk.shape[1]
    f8 = state.t_pk.shape[2]
    n_features = state.g_ls.shape[1]
    gs_l = gs.long()
    new_gs = state.g_num + _icumsum(active.to(_I32)) - 1

    t_pk = state.t_pk[gs_l]  # (K, tile, F8)
    t_pops = state.t_pops[gs_l]  # (K, tile)
    t_slot = state.t_slot[gs_l]  # (K, tile)
    occupied = t_slot >= 0

    # Seed centroid: exact group-CF majority vote, packed
    g_ls = state.g_ls[gs_l]
    g_n = state.g_n[gs_l]
    seed_bits = majority_centroid_from_sums(g_ls, g_n.clamp_min(1))
    seed_pk = pack_fingerprints_device(seed_bits)  # (K, F8)
    seed_pop = _isum(seed_bits, -1)

    def packed_sims(vec_pk, vec_pop):
        # Tanimoto of each tile cell vs a per-row packed vector
        inter = _popcount_u8(t_pk & vec_pk[:, None, :]).sum(dim=-1, dtype=_I32)
        union = t_pops + vec_pop[:, None] - inter
        sims = inter.to(torch.float32) / union.clamp_min(1).to(torch.float32)
        return torch.where(occupied, sims, 2.0)  # empty cells never argmin

    rows = torch.arange(k, device=dev)
    sims_seed = packed_sims(seed_pk, seed_pop)
    i1 = torch.argmin(sims_seed, dim=1)
    fp1 = t_pk[rows, i1]
    sims1 = packed_sims(fp1, t_pops[rows, i1])
    i2 = torch.argmin(sims1, dim=1)
    fp2 = t_pk[rows, i2]
    sims2 = packed_sims(fp2, t_pops[rows, i2])

    inf = float("inf")
    margin = sims1 - sims2
    margin = torch.where(occupied, margin, -inf)  # empty cells stay put
    col = torch.arange(tile, device=dev)[None, :].expand(k, tile)
    margin = torch.where(col == i1[:, None], inf, margin)
    margin = torch.where(col == i2[:, None], -inf, margin)
    # Balanced partition: top half (by margin, stable) moves to the new group
    order = torch.sort(-margin, dim=1, stable=True).indices  # sorted pos -> cell
    n_occ = _isum(occupied, 1)
    half = torch.div(n_occ, 2, rounding_mode="floor")
    pos_in_sort = torch.empty_like(order).scatter_(1, order, col.contiguous())
    to_new = occupied & (pos_in_sort < half[:, None])

    # Dense new positions within each half (stable by original cell order)
    def dense_pos(mask):
        mi = mask.to(_I32)
        return _icumsum(mi, 1) - mi

    pos_moved = dense_pos(to_new & occupied)
    pos_kept = dense_pos(~to_new & occupied)
    member_pos = torch.where(to_new, pos_moved, pos_kept)

    # Re-pack tiles: scatter each occupied cell into (half, new position);
    # empty source cells land in a trash column (tile) that is cut off
    half_idx = to_new.long()
    dst_cell = torch.where(occupied, member_pos.long(), tile)
    dst = ((rows[:, None] * 2 + half_idx) * (tile + 1) + dst_cell).reshape(-1)
    new_t_pk = torch.zeros((k * 2 * (tile + 1), f8), dtype=torch.uint8, device=dev)
    new_t_pk[dst] = t_pk.reshape(k * tile, f8)
    new_t_pops = torch.zeros((k * 2 * (tile + 1),), dtype=_I32, device=dev)
    new_t_pops[dst] = t_pops.reshape(-1)
    new_t_slot = torch.full((k * 2 * (tile + 1),), -1, dtype=_I32, device=dev)
    new_t_slot[dst] = t_slot.reshape(-1)
    new_t_pk = new_t_pk.view(k, 2, tile + 1, f8)[:, :, :tile].reshape(2 * k, tile, f8)
    new_t_pops = new_t_pops.view(k, 2, tile + 1)[:, :, :tile].reshape(2 * k, tile)
    new_t_slot = new_t_slot.view(k, 2, tile + 1)[:, :, :tile].reshape(2 * k, tile)

    # Group CFs of the two halves (read before any cluster table changes)
    w_moved = (to_new & occupied).to(_I32)
    slot_flat = t_slot.clamp_min(0).reshape(-1)
    cluster_ls = _cluster_ls_of(state, slot_flat, n_features).reshape(k, tile, -1)
    cluster_n = state.n[slot_flat.long()].reshape(k, tile)
    moved_ls = _isum(cluster_ls * w_moved[:, :, None], 1)
    del cluster_ls
    moved_n = _isum(cluster_n * w_moved, 1)
    kept_ls = g_ls - moved_ls
    kept_n = g_n - moved_n

    # Cluster -> (group, pos) updates for the live members
    live = (occupied & active[:, None]).reshape(-1)
    member_grp = torch.where(to_new, new_gs[:, None], gs[:, None]).reshape(-1)
    _drop_set_(state.group, t_slot.reshape(-1), member_grp, live)
    _drop_set_(state.pos, t_slot.reshape(-1), member_pos.reshape(-1), live)

    gi = torch.stack([gs, new_gs], dim=1).reshape(-1)
    keep = active[:, None].expand(k, 2).reshape(-1)
    pair_ls = torch.stack([kept_ls, moved_ls], dim=1).reshape(2 * k, -1)
    pair_n = torch.stack([kept_n, moved_n], dim=1).reshape(2 * k)
    pair_cent = majority_centroid_from_sums(pair_ls, pair_n.clamp_min(1))
    moved_cnt = _isum(w_moved, 1)
    pair_counts = torch.stack([n_occ - moved_cnt, moved_cnt], dim=1).reshape(2 * k)

    _drop_set_(state.t_pk, gi, new_t_pk, keep)
    _drop_set_(state.t_pops, gi, new_t_pops, keep)
    _drop_set_(state.t_slot, gi, new_t_slot, keep)
    _drop_set_(state.g_ls, gi, pair_ls, keep)
    _drop_set_(state.g_n, gi, pair_n, keep)
    _drop_set_(state.g_cent, gi, pair_cent.to(_CENT_DT), keep)
    _drop_set_(state.g_pops, gi, _isum(pair_cent, -1), keep)
    _drop_set_(state.g_count, gi, pair_counts, keep)
    return state._replace(g_num=state.g_num + _isum(active))


@spans.spanned("step.prep")
def _slice_prep_fp_rows_impl(
    dev_fps: torch.Tensor, start: int, n_valid: int, m: int, n_features: int
):
    r"""Slice ``m`` rows at ``start`` (clamped into range, like
    ``lax.dynamic_slice``), unpack, and build the CF rows; rows at rank
    ``>= n_valid`` are padding.  Every valid row is one fingerprint, so
    its flag (``row_single``, the last of the rows) is ``valid``."""
    start = min(max(start, 0), dev_fps.shape[0] - m)
    packed = dev_fps[start : start + m]
    valid = torch.arange(m, device=dev_fps.device) < n_valid
    bits = unpack_fingerprints_device(packed, n_features)
    row_ls = torch.where(valid[:, None], bits.to(_I32), 0)
    row_n = valid.to(_I32)
    row_cent = row_ls.to(_CENT_DT)
    row_pk = torch.where(valid[:, None], packed, 0)
    row_pop = _isum(row_ls, -1)
    return row_ls, row_n, row_cent, row_pk, row_pop, valid


def _stage_tail(dev_fps: torch.Tensor, n_valid: int, window: int) -> torch.Tensor:
    r"""Stage the trailing ``n_valid`` rows of a device-resident input into
    a fresh ``window``-row buffer (rows first, zero-padded), so that the
    final partial window's batch slices stay in bounds."""
    chunk = dev_fps[dev_fps.shape[0] - window :]
    rolled = torch.roll(chunk, n_valid - window, dims=0)
    rank = torch.arange(window, device=dev_fps.device)
    return torch.where((rank < n_valid)[:, None], rolled, 0)


def _prep_fp_rows(packed: torch.Tensor, valid: torch.Tensor, n_features: int):
    r"""CF-row prep from packed fingerprints (n = 1 rows; ``row_single``,
    the last of the rows, is ``valid``)."""
    bits = unpack_fingerprints_device(packed, n_features)
    row_ls = bits.to(_I32)
    row_n = valid.to(_I32)
    row_cent = bits.to(_CENT_DT)
    row_pop = _isum(row_ls, -1)
    return row_ls, row_n, row_cent, packed, row_pop, valid


def _scan_fit_packed_impl(
    state: BatchState,
    dev_fps: torch.Tensor,  # (R, F8) uint8 device-resident, R >= start+k*m
    start: int,  # row offset of the first batch
    n_valid: int,  # valid rows from ``start`` (rest = padding)
    threshold: torch.Tensor,
    tolerance: torch.Tensor,
    *,
    k: int,
    m: int,
    n_features: int,
    criterion: str,
    block: int,
    max_rounds: int,
    narrow: int,
    split_k: int,
    fanout: int,
) -> tuple[BatchState, torch.Tensor, torch.Tensor]:
    r"""Insert ``k`` consecutive batches of ``m`` rows (one scan window):
    per batch, slice + unpack -> batch step -> split pass when a group is
    near full (or, at the window's last batch, over ``fanout``).

    Returns (state, assigned (k, m), encs (k,)).  All-padding batches skip
    their step, which would commit nothing.
    """
    dev = dev_fps.device
    assigned = torch.full((k, m), -1, dtype=_I32, device=dev)
    encs = torch.zeros((k,), dtype=_I32, device=dev)
    tile_cap = state.t_pk.shape[1]
    for i in range(k):
        nv = min(max(n_valid - i * m, 0), m)
        if nv > 0:
            rows = _slice_prep_fp_rows_impl(dev_fps, start + i * m, nv, m, n_features)
            state, assigned[i], encs[i] = _batch_step_impl(
                state, *rows, threshold, tolerance, criterion=criterion,
                block=block, max_rounds=max_rounds, narrow=narrow,
            )
        # Per-batch split pass whenever a group nears its tile capacity, and
        # at the window's end whenever one exceeds fanout (rebalancing keeps
        # hot groups' candidate tiles whole)
        with spans.span("split"):
            g_cap = state.g_count.shape[0]
            live = torch.arange(g_cap, device=dev) < state.g_num
            top = _host_int(torch.where(live, state.g_count, 0).amax())
        if top > tile_cap - 16 or (i == k - 1 and top > fanout):
            state = _split_topk_impl(state, k=split_k, fanout=fanout)[0]
    return state, assigned, encs


def _reconstruct_ls_chunk(
    state: BatchState, start: int, chunk: int, n_features: int
) -> torch.Tensor:
    r"""Dense linear sums of cluster slots [start, start+chunk)."""
    slots = torch.arange(start, start + chunk, dtype=_I32, device=state.n.device)
    slots = slots.clamp_max(state.n.shape[0] - 1)
    return _cluster_ls_of(state, slots, n_features)


def _prep_buffer_rows(row_ls: torch.Tensor, row_n: torch.Tensor):
    r"""CF-row prep from pre-aggregated buffers (majority centroid rows).
    A row is flagged ``row_single`` (the last of the rows) where it is one
    fingerprint: a count of 1 and sums equal to its packed bits (a user's
    CF row or another shard's cluster may hold a count of 1 with other
    sums)."""
    cent = majority_centroid_from_sums(row_ls, row_n.clamp_min(1))
    row_pk = pack_fingerprints_device(cent)
    row_pop = _isum(cent.to(_I32), -1)
    row_single = (row_n == 1) & (row_ls == cent).all(-1)
    return row_ls, row_n, cent.to(_CENT_DT), row_pk, row_pop, row_single


def _predict_step(
    state: BatchState,
    packed: torch.Tensor,  # (M, F8) uint8 query rows
    valid: torch.Tensor,  # (M,) bool
    g_num: int,  # live groups (read on the host once per predict call)
    *,
    n_features: int,
    block: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    r"""Read-only nearest-cluster probe: route each query to its best group,
    then score that group's packed tile.

    The sorted search runs at the shapes where the JAX engine takes its
    sorted Pallas search; the per-row search everywhere else.  Returns
    (best_sim, slot), slot -1 where the routed tile holds no live cell.
    """
    bits = unpack_fingerprints_device(packed, n_features)
    row_cent = bits.to(_CENT_DT)
    row_pop = _isum(bits.to(_I32), -1)
    row_group = _route_groups(
        row_cent, row_pop, state.g_cent, state.g_pops, g_num, valid, block
    )
    m, f8 = packed.shape
    fc = state.t_pk.shape[1]
    if m % 64 == 0 and f8 % 128 == 0 and fc % 128 == 0:
        best_sim, best_slot = tile_search_sorted(
            packed, row_pop, row_group, state.t_pk, state.t_pops,
            state.t_slot, valid, guard_group=state.g_ls.shape[0] - 1,
        )
    else:
        best_sim, best_slot = tile_search_rows(
            packed, row_pop, row_group, state.t_pk, state.t_pops,
            state.t_slot, valid,
        )
    return best_sim, torch.where(best_sim > -1.5, best_slot, -1)


def _pool_dead_rows(state: BatchState) -> torch.Tensor:
    r"""``num_ls`` minus the live ``ls_ref`` count (see
    ``BatchTree.pool_dead_rows``)."""
    c_cap = state.n.shape[0]
    iota = torch.arange(c_cap, dtype=_I32, device=state.n.device)
    live = (iota < state.num) & (state.ls_ref >= 0)
    return state.num_ls - _isum(live)


def _load_rows_by_mol(
    X: "np.ndarray | Path | str | tp.Sequence[Path]",
    mol_ids: list[int],
    initial_mol: int,
    input_is_packed: bool,
) -> tuple[np.ndarray, list[int]]:
    r"""(packed fingerprint rows, matching mol ids) for ``mol_ids``, read
    from an array, an ``.npy`` file or a sequence of ``.npy`` files.

    File sequences require globally sorted indices, so the returned mol
    ids may be a permutation of the input.  A copy of the JAX engine's
    host-only helper (its module imports JAX).
    """
    arr_idxs = [m - initial_mol for m in mol_ids]
    if isinstance(X, (Path, str)):
        rows = np.asarray(np.load(X, mmap_mode="r")[arr_idxs])
    elif isinstance(X, np.ndarray):
        rows = X[arr_idxs]
    else:  # sequence of .npy paths
        from bblean_tpu_torch.fingerprints import _get_fingerprints_from_file_seq

        order = np.argsort(arr_idxs)
        rows = _get_fingerprints_from_file_seq(
            tp.cast(tp.Sequence[Path], X),
            [arr_idxs[i] for i in order],
        )
        mol_ids = [mol_ids[i] for i in order]
    rows = np.asarray(rows, dtype=np.uint8)
    if not input_is_packed:
        rows = np.packbits(rows, axis=-1)
    return rows, mol_ids


class BatchTree:
    r"""Host driver for the batched engine (data plane on the device,
    topology control plane on the host).

    ``fanout`` bounds the clusters per group (split trigger); ``tile`` is the
    static per-group tile capacity (must exceed ``fanout`` by enough headroom
    for in-batch creations).  ``device`` is where the tables live: CUDA
    runs the hand-written tile-search kernel, the CPU its plain version.
    """

    def __init__(
        self,
        n_features: int,
        *,
        threshold: float = 0.65,
        merge_criterion: str = "diameter",
        tolerance: float = 0.05,
        batch_size: int = 1024,
        fanout: int = 192,
        tile: int = 256,
        initial_capacity: int = 8192,
        ls_capacity: int | None = None,
        g_capacity: int | None = None,
        route_block: int = 1024,
        max_rounds: int = 24,
        pipeline_depth: int = 3,
        stage_windows: int = 8,
        device: str | torch.device = "cuda",
    ) -> None:
        if fanout >= tile:
            raise ValueError("fanout must be < tile (headroom for creations)")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "BatchTree(device='cuda') needs a CUDA device and none is "
                "available; pass device='cpu' to run the plain PyTorch path"
            )
        self.n_features = n_features
        self.n_bytes = (n_features + 7) // 8
        self.threshold = threshold
        self.merge_criterion = merge_criterion
        self.tolerance = tolerance
        self.batch_size = batch_size
        self.fanout = fanout
        self.tile = tile
        self.route_block = route_block
        self.max_rounds = max_rounds
        self.capacity = _next_pow2(max(initial_capacity, 2 * batch_size + 1))
        # Sparse linear-sum pool: only multi-member clusters hold a row; the
        # default is capped and the pool grows on demand like the others
        self.ls_capacity = _next_pow2(
            ls_capacity
            if ls_capacity is not None
            else max(min(self.capacity // 4, 1 << 17), 2 * batch_size + 1)
        )
        # Host-driver constants as the JAX engine has them (tuned for its
        # TPU; pipeline_depth decides when pending rows are retried, so
        # changing it changes labels)
        self.split_k = 64  # oversized groups split per pass
        self.scan_batches = 16  # batches per scan window
        # Group headroom: ~capacity/fanout with ~1.3x slack for split halves
        # and overflow chunks, plus one scan window's split/creation headroom
        self.g_capacity = _next_pow2(
            g_capacity
            if g_capacity is not None
            else max(
                256,
                self.capacity * 13 // (10 * max(fanout, 1))
                + self._scan_g_headroom(),
            )
        )
        self.state = _init_state(
            self.capacity, self.g_capacity, tile, n_features,
            self.ls_capacity, self.device,
        )
        # Host-side upper bounds on the device counters (_ensure_capacity)
        self._num_upper = 0
        self._g_upper = 1
        self._ls_upper = 0
        self.split_interval = 8
        # Scan windows kept queued before the oldest boundary is settled
        self.pipeline_depth = max(1, pipeline_depth)
        # Host inputs stage in chunks of `stage_windows` scan windows
        self.stage_windows = max(1, stage_windows)
        self._boundary_queue: list[dict] = []
        # Per-inserted-row slot assignments + mol bookkeeping (host side):
        # flat mol ids per scan window, a list of mol ids per row for a
        # user's buffers, (flat mol ids, one length a row) for the buffers
        # of a refine or a recluster
        self._row_slots: list[tuple[tp.Any, int]] = []
        self._row_mols: list[
            np.ndarray | list[list[int]] | tuple[np.ndarray, np.ndarray]
        ] = []

    def _scalars(self) -> tuple[torch.Tensor, torch.Tensor]:
        f32 = dict(dtype=torch.float32, device=self.device)
        return torch.tensor(self.threshold, **f32), torch.tensor(self.tolerance, **f32)

    @property
    def num_clusters(self) -> int:
        num = _host_int(self.state.num)
        self._num_upper = num
        return num

    @property
    def num_groups(self) -> int:
        g_num = _host_int(self.state.g_num)
        self._g_upper = g_num
        return g_num

    @property
    def pool_dead_rows(self) -> int:
        r"""Leaked linear-sum pool rows (telemetry).

        In-step guards can kill a multi-member creation after its pool ref
        was consumed by the allocation cumsum (the ``fits_g`` kill site in
        ``_insert_round``).  Slots are never freed, so every live ref
        belongs to a live slot and the dead count is exactly
        ``num_ls - #live refs``.  The device ``num_ls`` counter includes
        dead rows, so leaks cost pool growth, never corruption.
        """
        return _host_int(_pool_dead_rows(self.state))

    def _scan_g_headroom(self) -> int:
        r"""Free group slots demanded before a scan window runs: 2x the
        window's split-pass creations plus an estimate of overflow-chunk
        creations (~4 per tile of rows)."""
        k, m = self.scan_batches, self.batch_size
        return 2 * k * (self.split_k + 4 * (m // self.tile + 4))

    def _ensure_capacity(
        self,
        incoming: int,
        g_incoming: int | None = None,
        p_incoming: int | None = None,
    ) -> None:
        r"""Grow tables if needed, using host-side upper bounds on the
        device counters; exact counts are read only near the capacity edge.
        Underestimates are safe: the step's in-table guards leave
        unplaceable rows pending and the flush boundary grows + retries."""
        if g_incoming is None:
            g_incoming = incoming
        if p_incoming is None:
            p_incoming = incoming
        # +1: the top slot of each table is a scatter guard and stays free
        if self._num_upper + incoming + 1 > self.capacity:
            self._num_upper = _host_int(self.state.num)
        if self._g_upper + g_incoming + 1 > self.g_capacity:
            self._g_upper = _host_int(self.state.g_num)
        if self._ls_upper + p_incoming + 1 > self.ls_capacity:
            self._ls_upper = _host_int(self.state.num_ls)
        need_c = self._num_upper + incoming + 1
        need_g = self._g_upper + g_incoming + 1
        need_p = self._ls_upper + p_incoming + 1
        new_c, new_g = self.capacity, self.g_capacity
        new_p = self.ls_capacity
        while new_c < need_c:
            new_c *= 2
        while new_g < need_g:
            new_g *= 2
        while new_p < need_p:
            new_p *= 2
        if (new_c, new_g, new_p) != (
            self.capacity, self.g_capacity, self.ls_capacity
        ):
            with spans.span("grow"):
                self.state = _grow_state(self.state, new_c, new_g, new_p)
            self.capacity, self.g_capacity = new_c, new_g
            self.ls_capacity = new_p

    # -- insertion -----------------------------------------------------------

    @spans.spanned("fit")
    def fit_packed(
        self,
        packed_fps: np.ndarray | torch.Tensor,
        mol_indices: tp.Sequence[int],
    ) -> None:
        r"""Insert packed fingerprints in scan windows of ``scan_batches``
        batches.

        A torch tensor is used where it lies (moved to ``device`` first if
        it is elsewhere) and sliced in place; a host array is uploaded in
        chunks of ``stage_windows`` windows.  Both give the same batches,
        hence the same labels.
        """
        num = len(packed_fps)
        if num and packed_fps.shape[-1] != self.n_bytes:
            raise ValueError(
                f"packed rows have {packed_fps.shape[-1]} bytes, expected "
                f"{self.n_bytes} for {self.n_features} features (already-"
                "packed input passed through packbits again is the usual "
                "cause; make_fake_fingerprints returns PACKED rows)"
            )
        mol_arr = np.fromiter(mol_indices, dtype=np.int64, count=num)
        m = self.batch_size
        k = self.scan_batches
        window = k * m
        on_device = isinstance(packed_fps, torch.Tensor)
        if on_device:
            packed_fps = packed_fps.to(self.device, torch.uint8)
            if num < window:
                # Small device input: pad once so the single window's
                # slices stay in bounds
                packed_fps = _pad_rows(packed_fps, window)
        elif not isinstance(packed_fps, np.ndarray):
            packed_fps = np.asarray(packed_fps)

        # A device-resident input is never padded in place; a final partial
        # window stages its rows into a window-sized buffer
        tail_buf = None
        if on_device and num > window and num % window:
            tail_buf = _stage_tail(packed_fps, num % window, window)

        # Chunked host staging: one upload per `stage_windows` windows; a
        # single-window input keeps the window-sized buffer
        n_windows = -(-num // window) if num else 1
        chunk_rows = (1 if n_windows <= 1 else self.stage_windows) * window

        def upload_chunk(cstart: int) -> torch.Tensor:
            stop = min(cstart + chunk_rows, num)
            with spans.span("stage_chunk"):
                chunk = packed_fps[cstart:stop]
                if stop - cstart < chunk_rows:
                    chunk = np.pad(chunk, ((0, chunk_rows - (stop - cstart)), (0, 0)))
                return torch.from_numpy(np.ascontiguousarray(chunk, np.uint8)).to(self.device)

        cur_chunk = None
        for start in range(0, num, window):
            stop = min(start + window, num)
            n_valid = stop - start
            if on_device:
                if tail_buf is not None and n_valid < window:
                    dev_buf, dev_start = tail_buf, 0
                else:
                    dev_buf, dev_start = packed_fps, start
            else:
                coff = start % chunk_rows
                if coff == 0:
                    cur_chunk = upload_chunk(start)
                dev_buf, dev_start = cur_chunk, coff
            self._submit_scan(dev_buf, dev_start, n_valid, mol_arr[start:stop])
        self.flush()

    def warm_programs(self, dev_fps: np.ndarray | torch.Tensor) -> None:
        r"""Run the retry path's step and ``max(2, pipeline_depth)`` scan
        windows once with zero valid rows; every state table stays as it
        is (bar the split pass that a flush would run anyway).

        PyTorch runs eagerly, so there is no compile step to warm: on the
        card this builds (or loads) the kernels and warms the caching
        allocator with the step's and the windows' working set.
        ``dev_fps`` must hold at least ``scan_batches * batch_size`` rows.
        """
        m = self.batch_size
        dev_fps = torch.as_tensor(dev_fps).to(self.device, torch.uint8)
        if self.device.type == "cuda":
            tile_search.kernel.lib()
            refresh.kernel.lib()
        thr, tol = self._scalars()
        rows = _slice_prep_fp_rows_impl(dev_fps, 0, 0, m, self.n_features)
        self.state, _assigned, _enc = _batch_step_impl(
            self.state, *rows, thr, tol, criterion=self.merge_criterion,
            block=self.route_block, max_rounds=self.max_rounds, narrow=m // 4,
        )
        self._split_oversized_groups()
        for _ in range(max(2, self.pipeline_depth)):
            self.state, _a, _e = _scan_fit_packed_impl(
                self.state, dev_fps, 0, 0, thr, tol,
                k=self.scan_batches, m=m, n_features=self.n_features,
                criterion=self.merge_criterion, block=self.route_block,
                max_rounds=self.max_rounds, narrow=m // 4,
                split_k=self.split_k, fanout=self.fanout,
            )
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @spans.spanned("window")
    def _submit_scan(
        self,
        dev_fps: torch.Tensor,
        start_row: int,
        n_valid: int,
        mols: np.ndarray,
    ) -> None:
        r"""Run one k-batch scan window and queue its flush boundary."""
        m, k = self.batch_size, self.scan_batches
        # p_incoming=0: pool allocations are guarded in-step (overflow rows
        # pend and the flush grows + retries)
        self._ensure_capacity(
            k * m, g_incoming=self._scan_g_headroom(), p_incoming=0
        )
        thr, tol = self._scalars()
        self.state, assigned, encs = _scan_fit_packed_impl(
            self.state, dev_fps, start_row, n_valid, thr, tol,
            k=k, m=m, n_features=self.n_features,
            criterion=self.merge_criterion, block=self.route_block,
            max_rounds=self.max_rounds, narrow=m // 4,
            split_k=self.split_k, fanout=self.fanout,
        )
        self._num_upper += n_valid
        self._g_upper += k * self.split_k + max(
            16, 4 * (n_valid // self.tile + 1)
        )
        self._row_slots.append((assigned.reshape(-1), n_valid))
        self._row_mols.append(mols)
        self._boundary_queue.append(
            {
                "slot_idx": len(self._row_slots) - 1,
                "dev_fps": dev_fps,
                "start": start_row,
                "n_valid": n_valid,
                # The window's encs plus the table counters as of this
                # window, read when the boundary is settled
                "sync": torch.cat(
                    [
                        encs,
                        torch.stack(
                            [self.state.num, self.state.g_num, self.state.num_ls]
                        ),
                    ]
                ),
            }
        )
        # Keep up to `pipeline_depth` windows queued before settling the
        # oldest one's retries (retries run against the then-current state)
        while len(self._boundary_queue) > self.pipeline_depth:
            self._process_oldest_boundary()

    def insert_fps(
        self, unpacked_fps: np.ndarray, mol_indices: tp.Sequence[int]
    ) -> None:
        r"""Insert unpacked 0/1 fingerprints (one CF row of n=1 each)."""
        self.fit_packed(
            np.packbits(np.asarray(unpacked_fps, dtype=np.uint8), axis=-1),
            mol_indices,
        )

    @spans.spanned("buffers")
    def insert_buffers(
        self,
        buffers: np.ndarray,
        mol_index_seqs: tp.Sequence[tp.Sequence[int]],
    ) -> None:
        r"""Insert pre-aggregated CF buffers ``[linear_sum..., n]``, one row
        per buffer, in batches of ``batch_size`` (the last one padded)."""
        ls = np.asarray(buffers)[:, :-1].astype(np.int32)
        ns = np.asarray(buffers)[:, -1].astype(np.int32)
        mols = [list(s) for s in mol_index_seqs]
        m = self.batch_size
        for start in range(0, len(ls), m):
            stop = min(start + m, len(ls))
            with spans.span("buffers.stage"):
                chunk_ls = ls[start:stop]
                chunk_n = ns[start:stop]
                pad = m - (stop - start)
                if pad:
                    chunk_ls = np.pad(chunk_ls, ((0, pad), (0, 0)))
                    chunk_n = np.pad(chunk_n, (0, pad))
                rows = _prep_buffer_rows(
                    torch.from_numpy(np.ascontiguousarray(chunk_ls)).to(self.device),
                    torch.from_numpy(np.ascontiguousarray(chunk_n)).to(self.device),
                )
            self._submit_batch(rows, mols[start:stop], chunk_n > 0)
        self.flush()

    @spans.spanned("buffers")
    def _insert_survivors(self, surv: _Survivors) -> None:
        r"""``insert_buffers`` for clusters gathered on the device: each
        batch is assembled there from ``surv``, which is freed once the
        last batch is submitted."""
        global refine_device_buffer_rows
        m = self.batch_size
        for start in range(0, len(surv), m):
            with spans.span("buffers.stage"):
                rows, mols, host_valid = surv.batch(start, m, self.n_features)
            self._submit_batch(rows, mols, host_valid)
        refine_device_buffer_rows += len(surv)
        surv.drop()
        self.flush()

    def _submit_batch(
        self,
        rows: tuple[torch.Tensor, ...],
        mols: list[list[int]] | tuple[np.ndarray, np.ndarray],
        host_valid: np.ndarray,
    ) -> None:
        r"""Run one batch step and queue its boundary (settled, with its
        retries, every ``split_interval`` batches).  ``mols`` holds one
        entry a row: a list of mol ids each, or flat ids and lengths."""
        m = self.batch_size
        self._ensure_capacity(m)
        thr, tol = self._scalars()
        self.state, assigned, enc = _batch_step_impl(
            self.state, *rows, thr, tol, criterion=self.merge_criterion,
            block=self.route_block, max_rounds=self.max_rounds, narrow=m // 4,
        )
        n_valid = int(host_valid.sum())
        self._num_upper += n_valid
        self._ls_upper += n_valid  # promotions + pooled creations <= rows
        # Creations open at most ceil(n/tile) chunk groups per routed group;
        # in-step clamping pends anything beyond capacity
        self._g_upper += max(16, 4 * (n_valid // self.tile + 1))
        count = len(mols[1]) if isinstance(mols, tuple) else len(mols)
        self._row_slots.append((assigned, count))
        self._row_mols.append(mols)
        self._boundary_queue.append(
            {
                "slot_idx": len(self._row_slots) - 1,
                "rows": rows,
                "host_valid": host_valid,
                "enc": enc,
            }
        )
        # One split pass per batch keeps saturated groups from shedding a
        # near-empty overflow chunk group every batch
        self._split_oversized_groups()
        if len(self._boundary_queue) >= self.split_interval:
            self.flush()

    def flush(self) -> None:
        r"""Settle every queued boundary, then a final split pass."""
        while self._boundary_queue:
            self._process_oldest_boundary()
        self._split_oversized_groups()

    @spans.spanned("boundary")
    def _process_oldest_boundary(self) -> None:
        r"""Pop and settle the OLDEST queued boundary.  A scan window's
        refreshes the host's counter bounds from its sync payload and
        retries its pending rows; a single batch's reads its ``enc`` and
        retries the batch if rows are left."""
        q = self._boundary_queue.pop(0)
        if "sync" not in q:
            if _host_int(q["enc"]) // 1000 > 0:
                self._retry_batch(q)
                self._split_oversized_groups()
            return
        k = self.scan_batches
        flat = _host(q["sync"])
        pending = flat[:-3] // 1000
        # True table counters as of this window, plus the worst-case
        # contributions of the newer windows already run
        extra_rows = sum(q2["n_valid"] for q2 in self._boundary_queue)
        extra_g = sum(
            k * self.split_k + max(16, 4 * (q2["n_valid"] // self.tile + 1))
            for q2 in self._boundary_queue
        )
        self._num_upper = int(flat[-3]) + extra_rows
        self._g_upper = int(flat[-2]) + extra_g
        # Pool bound: queued windows are not charged per row (the in-step
        # pool guard pends rows on exhaustion); charge a 2*m margin each
        self._ls_upper = int(flat[-1]) + 2 * self.batch_size * len(
            self._boundary_queue
        )
        # Proactive pool headroom while the counters are fresh
        self._ensure_capacity(0, g_incoming=0, p_incoming=2 * self.batch_size)
        if (pending > 0).any():
            self._retry_scan(q, pending)
            self._split_oversized_groups()

    @spans.spanned("retry")
    def _retry_batch(self, q: dict) -> None:
        r"""Drain a batch whose step exhausted max_rounds (rare): split, mask
        the already-assigned rows, re-step until done."""
        row_ls, row_n, row_cent, row_pk, row_pop, row_single = q["rows"]
        host_valid = q["host_valid"]
        assigned_dev, count = self._row_slots[q["slot_idx"]]
        final = np.array(_host(assigned_dev))
        thr, tol = self._scalars()
        for _attempt in range(64):
            missing = (final == -1) & host_valid
            if not missing.any():
                break
            self._split_oversized_groups(drain=True)
            row_n = torch.where(torch.from_numpy(missing).to(self.device), row_n, 0)
            self._ensure_capacity(self.batch_size)
            self.state, assigned, _enc = _batch_step_impl(
                self.state, row_ls, row_n, row_cent, row_pk, row_pop, row_single,
                thr, tol, criterion=self.merge_criterion,
                block=self.route_block, max_rounds=self.max_rounds,
                narrow=self.batch_size // 4,
            )
            n_miss = int(missing.sum())
            self._num_upper += n_miss
            self._g_upper += n_miss
            self._ls_upper += n_miss
            final[missing] = _host(assigned)[missing]
        else:
            raise RuntimeError("batch engine failed to drain a batch")
        self._row_slots[q["slot_idx"]] = (final, count)

    @spans.spanned("retry")
    def _retry_scan(self, q: dict, pending_per_batch: np.ndarray) -> None:
        r"""Drain a scan window some of whose batches exhausted max_rounds
        (rare): split, rebuild each pending batch's rows from the staged
        fps, mask the already-assigned rows and re-step until done."""
        m, k = self.batch_size, self.scan_batches
        assigned_dev, n_valid = self._row_slots[q["slot_idx"]]
        final = np.array(_host(assigned_dev))
        valid = np.zeros(k * m, bool)
        valid[:n_valid] = True
        thr, tol = self._scalars()
        for i in range(k):
            if pending_per_batch[i] <= 0:
                continue
            seg = slice(i * m, (i + 1) * m)
            seg_final = final[seg]
            seg_valid = valid[seg]
            for _attempt in range(64):
                missing = (seg_final == -1) & seg_valid
                if not missing.any():
                    break
                self._split_oversized_groups(drain=True)
                row_ls, row_n, row_cent, row_pk, row_pop, row_single = _slice_prep_fp_rows_impl(
                    q["dev_fps"], q["start"] + i * m,
                    max(0, min(m, q["n_valid"] - i * m)), m, self.n_features,
                )
                row_n = torch.where(
                    torch.from_numpy(missing).to(self.device), row_n, 0
                )
                self._ensure_capacity(m)
                self.state, assigned, _enc = _batch_step_impl(
                    self.state, row_ls, row_n, row_cent, row_pk, row_pop, row_single,
                    thr, tol, criterion=self.merge_criterion,
                    block=self.route_block, max_rounds=self.max_rounds,
                    narrow=m // 4,
                )
                n_miss = int(missing.sum())
                self._num_upper += n_miss
                self._g_upper += n_miss
                self._ls_upper += n_miss
                seg_final[missing] = _host(assigned)[missing]
            else:
                raise RuntimeError("batch engine failed to drain a window")
            final[seg] = seg_final
        self._row_slots[q["slot_idx"]] = (final, n_valid)

    # -- host control plane: group splits ------------------------------------

    def _split_oversized_groups(self, drain: bool = False) -> None:
        r"""Split groups whose cluster count exceeds ``fanout``, ``split_k``
        per pass; ``drain`` repeats until none is oversized."""
        k = self.split_k
        for _ in range(64):
            self._ensure_capacity(k)
            self.state, n_left = _split_topk_impl(
                self.state, k=k, fanout=self.fanout
            )
            self._g_upper += k
            if not drain or _host_int(n_left) <= 0:
                return

    # -- refinement ----------------------------------------------------------

    def reset(
        self,
        *,
        threshold: float | None = None,
        merge_criterion: str | None = None,
        tolerance: float | None = None,
    ) -> None:
        r"""Drop all clusters (a fresh state on ``device`` and cleared host
        bookkeeping), optionally switching the merge criterion, threshold
        or tolerance for the next fit.  Capacities are kept.  The old
        tables are released before the new ones are made, so the device
        never holds both."""
        if threshold is not None:
            self.threshold = threshold
        if merge_criterion is not None:
            self.merge_criterion = merge_criterion
        if tolerance is not None:
            self.tolerance = tolerance
        self.state = None
        self.state = _init_state(
            self.capacity, self.g_capacity, self.tile, self.n_features,
            self.ls_capacity, self.device,
        )
        self._num_upper = 0
        self._g_upper = 1
        self._ls_upper = 0
        self._boundary_queue = []
        self._row_slots = []
        self._row_mols = []

    @spans.spanned("refine")
    def refine_inplace(
        self,
        X: "np.ndarray | Path | str | tp.Sequence[Path]",
        initial_mol: int = 0,
        input_is_packed: bool = True,
        n_largest: int = 1,
        *,
        threshold: float | None = None,
        merge_criterion: str | None = None,
        tolerance: float | None = None,
    ) -> "BatchTree":
        r"""Explode the ``n_largest`` clusters into singletons and re-fit.

        Three stages, each timed into the module's ``refine_*_ns``
        counters: the clusters are ordered by size on the host, their
        members taken as one flat id array, the survivors' counts and sums
        gathered on the device, and the tree reset; the survivors
        re-insert whole as CF buffer rows, largest first, each batch
        assembled on the device; then the exploded rows re-insert as
        singletons (their fingerprints are reloaded from ``X`` by molecule
        id).
        """
        global refine_calls, refine_buffer_rows, refine_exploded_rows
        global refine_extract_ns, refine_buffers_ns, refine_rows_ns
        if n_largest < 0:
            raise ValueError("n_largest must be >= 0")
        t0 = time.perf_counter_ns()
        with spans.span("refine.extract"):
            sizes = self.cluster_sizes()
            order = np.argsort(-sizes, kind="stable")
            big, rest = order[:n_largest], order[n_largest:]
            flat, bounds = self._cluster_members()
            exploded_mols = _regroup(flat, bounds, big)[0].tolist()
            surv = _Survivors(self.state, rest, sizes, *_regroup(flat, bounds, rest))
            self.reset(
                threshold=threshold, merge_criterion=merge_criterion,
                tolerance=tolerance,
            )
        t1 = time.perf_counter_ns()
        if len(surv):
            self._insert_survivors(surv)
        t2 = time.perf_counter_ns()
        with spans.span("refine.load"):
            rows, row_mols = _load_rows_by_mol(
                X, exploded_mols, initial_mol, input_is_packed
            )
        if len(rows):
            self.fit_packed(rows, row_mols)
        t3 = time.perf_counter_ns()
        refine_calls += 1
        refine_buffer_rows += len(surv)
        refine_exploded_rows += len(rows)
        refine_extract_ns += t1 - t0
        refine_buffers_ns += t2 - t1
        refine_rows_ns += t3 - t2
        return self

    def recluster_inplace(
        self,
        iterations: int = 1,
        extra_threshold: float = 0.0,
        shuffle: bool = False,
        seed: int | None = None,
    ) -> "BatchTree":
        r"""Re-insert every cluster as a CF buffer, optionally shuffled (a
        numpy generator seeded with ``seed``), raising the threshold by
        ``extra_threshold`` per iteration."""
        rng = np.random.default_rng(seed)
        for _ in range(iterations):
            sizes = self.cluster_sizes()
            order = (
                rng.permutation(len(sizes))
                if shuffle
                else np.argsort(-sizes, kind="stable")
            )
            members = _regroup(*self._cluster_members(), order)
            surv = _Survivors(self.state, order, sizes, *members)
            self.reset(threshold=self.threshold + extra_threshold)
            self._insert_survivors(surv)
        return self

    # -- extraction ----------------------------------------------------------

    def cluster_sizes(self) -> np.ndarray:
        self.flush()
        return _host(self.state.n)[: self.num_clusters]

    def linear_sums(self) -> np.ndarray:
        r"""Dense (C, F) int32 linear sums, rebuilt from the sparse pool and
        the singletons' tile bits in chunks of 2^15 slots."""
        self.flush()
        ncl = self.num_clusters
        out = np.empty((ncl, self.n_features), np.int32)
        chunk = 1 << 15
        for start in range(0, ncl, chunk):
            size = min(chunk, ncl - start)
            rows = _reconstruct_ls_chunk(self.state, start, chunk, self.n_features)
            out[start : start + size] = _host(rows)[:size]
        return out

    def packed_centroids(self) -> np.ndarray:
        r"""Majority-vote centroids of all clusters, packed uint8."""
        ls = self.linear_sums()
        n = self.cluster_sizes()
        cent = np.where(
            (n > 1)[:, None], ls >= (n[:, None] * 0.5), np.clip(ls, 0, 1)
        ).astype(np.uint8)
        return np.packbits(cent, axis=-1)

    def predict_packed(
        self, packed_fps: np.ndarray, *, batch: int = 8192
    ) -> tuple[np.ndarray, np.ndarray]:
        r"""Nearest-cluster probe for new (packed) fingerprints, read-only.

        Returns ``(slots, sims)``: the best cluster slot per query (the id
        space of :meth:`assignments`; -1 when the routed tile is empty) and
        the float64 value of the f32 Tanimoto similarity to that cluster's
        centroid.  Queries go in batches of ``batch`` (the last padded);
        the search's launch mode follows the batch's shape
        (:func:`_predict_step`).
        """
        self.flush()
        num = len(packed_fps)
        g_num = self.num_groups
        slots = np.empty(num, np.int64)
        sims = np.empty(num, np.float64)
        for start in range(0, num, batch):
            chunk = np.asarray(packed_fps[start : start + batch], np.uint8)
            n_valid = len(chunk)
            if n_valid < batch:
                chunk = np.pad(chunk, ((0, batch - n_valid), (0, 0)))
            valid = np.zeros(batch, bool)
            valid[:n_valid] = True
            sim, slot = _predict_step(
                self.state,
                torch.from_numpy(np.ascontiguousarray(chunk)).to(self.device),
                torch.from_numpy(valid).to(self.device), g_num,
                n_features=self.n_features, block=self.route_block,
            )
            slots[start : start + n_valid] = _host(slot)[:n_valid]
            sims[start : start + n_valid] = _host(sim)[:n_valid]
        return slots, sims

    def _materialize_slots(self) -> None:
        r"""Pull the device-side assignment vectors in one transfer."""
        device_idx = [
            i for i, (s, _c) in enumerate(self._row_slots)
            if isinstance(s, torch.Tensor)
        ]
        if device_idx:
            flat = _host(torch.cat([self._row_slots[i][0] for i in device_idx]))
            off = 0
            for i in device_idx:
                s, count = self._row_slots[i]
                self._row_slots[i] = (flat[off : off + s.shape[0]], count)
                off += s.shape[0]
        self._row_slots = [(s[:c], c) for s, c in self._row_slots]

    def _flat_assignments(self) -> tuple[np.ndarray, np.ndarray]:
        r"""(mol ids, cluster slot per mol) over every inserted row, in
        insertion order; a buffer row's slot repeats for each of its mols."""
        self.flush()
        self._materialize_slots()
        mol_parts: list[np.ndarray] = []
        slot_parts: list[np.ndarray] = []
        for (slots, _count), mols in zip(self._row_slots, self._row_mols):
            if isinstance(mols, np.ndarray):  # singleton rows, flat ids
                mol_parts.append(mols)
                slot_parts.append(slots)
            elif isinstance(mols, tuple):  # buffer rows: flat ids, lengths
                flat, lens = mols
                mol_parts.append(flat)
                slot_parts.append(np.repeat(slots[: len(lens)], lens))
            else:  # buffer rows: one list of mol ids per row
                lens = np.fromiter(
                    (len(ml) for ml in mols), dtype=np.int64, count=len(mols)
                )
                if lens.sum() == 0:
                    continue
                mol_parts.append(
                    np.concatenate([np.asarray(ml, np.int64) for ml in mols if ml])
                )
                slot_parts.append(np.repeat(slots[: len(mols)], lens))
        if not mol_parts:
            return np.empty(0, np.int64), np.empty(0, np.int64)
        return (
            np.concatenate(mol_parts),
            np.concatenate(slot_parts).astype(np.int64, copy=False),
        )

    def assignments(self) -> np.ndarray:
        r"""Cluster slot per molecule id, as one int array (0-based slots)."""
        mols, slots = self._flat_assignments()
        out = np.full(int(mols.max()) + 1 if len(mols) else 0, -1, np.int64)
        out[mols] = slots
        return out

    def _cluster_members(self) -> tuple[np.ndarray, np.ndarray]:
        r"""Molecule ids of every cluster slot, in slot order and insertion
        order within a slot, as one flat int64 array and the ``C + 1``
        offsets that bound each slot's ids."""
        ncl = self.num_clusters
        mols, slots = self._flat_assignments()
        order = np.argsort(slots, kind="stable")  # keeps insertion order
        bounds = np.searchsorted(slots[order], np.arange(ncl + 1), side="left")
        return mols[order], bounds

    def cluster_mols(self) -> list[list[int]]:
        r"""Molecule ids per cluster slot (slot order, not size order)."""
        flat, bounds = self._cluster_members()
        flat, bounds = flat.tolist(), bounds.tolist()
        return [flat[bounds[i] : bounds[i + 1]] for i in range(len(bounds) - 1)]


def _next_pow2(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p
