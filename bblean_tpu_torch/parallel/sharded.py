r"""Sharded clustering on the BatchTree control plane.

Port of ``bblean_tpu/parallel/sharded.py``: the repo's answer to the
reference's multiround pipeline.  Instead of worker processes exchanging
CF files bin by bin, a 1-D mesh runs one batched CF-forest per shard and
merges them pairwise.

**One process, a list of shards.**  The JAX engine stacks the shards'
states along a device axis and runs ``shard_map`` programs on them.  Here a
forest holds a list of :class:`BatchState`, each on the ``torch.device``
its mesh entry names, and the host thread dispatches the shards of a
window one after another.  A mesh may name one device several times
(``get_mesh(devices=["cuda:0"] * 8)``): the shards then share it and the
exchange moves nothing.  What JAX runs on every device, masked, runs here
only on the shards it can change; the split passes run on every shard, as
JAX's do, because they change a shard whether or not it has rows pending.

**Fit phase** -- inputs within ``resident_input_bytes`` (and every tensor
input) go to the mesh's first device once, are padded there to whole
windows and cut window-major: shard ``d`` owns the contiguous block
``[d * k * m, (d + 1) * k * m)`` of each window of
``n_shards * scan_batches * batch_size`` rows (a view on a shared device,
one copy to another card).  Larger inputs stream through the host in chunks
of ``stage_windows`` windows laid out the same way, so both paths compose
identical batches and give identical labels.  Nothing is exchanged during
the fit; each shard's state is the sparse bounded structure ``BatchTree``
uses, and capacity grows on demand, uniformly over the live shards, from
the clusters they discover.

**Merge phase** -- ``ceil(log2(D))`` reduction rounds (the reference's
midsection rounds over file pairs).  Each round:

1. *Exchange*: shard ``s`` with ``s % (2 * stride) == stride`` sends its
   whole state to shard ``s - stride`` (``tensor.to(device)``: a peer copy
   between cards, nothing between shards of one device) and is freed.
2. *Group-gated merge* on the receiver: every received GROUP is scored
   against the receiver's routing table (one int8 matrix product).
   Received groups with no similar own group -- the common case for
   shard-local clusters -- are **bulk-appended**: their tiles, CFs and pool
   rows are copied into the receiver's tables as whole blocks, no per-row
   work.  Only received groups that closely match an own group (candidate
   cross-shard duplicates) have their member clusters re-inserted row by
   row through the batch-step rounds, largest first.

The gate makes the merge cost follow the actual cross-shard overlap
instead of the total cluster count.  ``merge_gate_margin`` controls the
trade: the gate is ``merge_threshold - margin``; a margin >= 1 sends every
group through the row-level path.

Labels are composed on the host from the per-round assignment maps; own
rows never renumber (inserting received rows into an existing forest
leaves existing slots fixed), so only receiver-side maps are kept.
"""

from __future__ import annotations

import math
import typing as tp
import warnings

import numpy as np
import torch

from bblean_tpu_torch.engine import batch as _batch
from bblean_tpu_torch.engine.batch import (
    _I32,
    _NEG,
    BatchState,
    _batch_step_impl,
    _cluster_ls_of,
    _grow_state,
    _host,
    _host_int,
    _icumsum,
    _init_state,
    _isum,
    _load_rows_by_mol,
    _next_pow2,
    _pad_rows,
    _prep_buffer_rows,
    _reconstruct_ls_chunk,
    _scan_fit_packed_impl,
    _slice_prep_fp_rows_impl,
    _split_topk_impl,
)
from bblean_tpu_torch.ops import tile_search
from bblean_tpu_torch.ops.tanimoto import _int8_gram, _pad_int8
from bblean_tpu_torch.parallel.mesh import Mesh, get_mesh

__all__ = ["sharded_fit", "ShardedClusters", "ShardedForest"]


class ShardedClusters(tp.NamedTuple):
    r"""Result of a sharded fit (host-side)."""

    labels: np.ndarray  # (N,) final cluster slot per input row
    linear_sums: np.ndarray  # (C, F) merged cluster linear sums
    sizes: np.ndarray  # (C,) merged cluster sizes
    num_clusters: int


def _nonzero(mask: torch.Tensor) -> torch.Tensor:
    r"""Indices of the set entries of a 1-D mask (its length is a host
    read, counted with the engine's)."""
    _batch.host_syncs += 1
    return mask.nonzero().squeeze(1)


def _upload(rows: np.ndarray, device: torch.device) -> torch.Tensor:
    r"""A host array (a read-only file mapping too) as a tensor on
    ``device``; the tensor is only ever read."""
    with warnings.catch_warnings():
        warnings.filterwarnings(
            "ignore", message="The given NumPy array is not writable"
        )
        return torch.from_numpy(np.ascontiguousarray(rows)).to(device)


def _best_group_sim(
    q_cent: torch.Tensor,  # (Q, F) int8 query centroids (0/1 values)
    q_pops: torch.Tensor,  # (Q,) int32
    g_cent: torch.Tensor,  # (G_cap, F) int8 (0/1 values)
    g_pops: torch.Tensor,  # (G_cap,) int32
    g_num: int,  # live groups (read on the host by the caller)
    block: int,
) -> torch.Tensor:
    r"""Max Tanimoto of each query centroid over the live groups, in blocks
    of ``block`` groups (the similarity twin of ``_route_groups``)."""
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


def _insert_slots_impl(
    state: BatchState,
    recv: BatchState,
    ins_mask: torch.Tensor,  # (RC_cap,) bool: received slots to insert row-level
    amap: torch.Tensor,  # (RC_cap,) int32 assignment map (updated where assigned)
    threshold: torch.Tensor,
    tolerance: torch.Tensor,
    *,
    m_b: int,
    criterion: str,
    block: int,
    max_rounds: int,
    split_k: int,
    fanout: int,
) -> tuple[BatchState, torch.Tensor, int]:
    r"""Insert the masked received clusters into ``state`` as CF rows,
    largest first, in ``m_b``-row batch steps with a split pass per batch.

    The batch count is ``ceil(n_ins / m_b)`` (one host read), so the cost
    follows the rows actually inserted.  Rows the step could not place keep
    ``amap == -1`` (the host grows capacity and retries).  Every mask and
    map is sized by ``recv``, which keeps its capacity when ``state`` grew.
    Returns (state, amap, rows inserted).
    """
    rc = recv.n.shape[0]
    dev = recv.n.device
    n_features = state.g_ls.shape[1]
    # Largest first among the masked slots; everything else sorts last
    nkey = torch.where(ins_mask, -recv.n, 1 << 30)
    order = torch.sort(nkey, stable=True).indices
    # Slack so that the last batch's slice stays in bounds
    order = torch.cat([order, order.new_zeros(m_b)])
    n_ins = _host_int(_isum(ins_mask))
    iota_b = torch.arange(m_b, dtype=_I32, device=dev)
    # One trash cell past the map takes the rows that were not placed
    amap = torch.cat([amap, amap.new_full((1,), -1)])
    for b in range(-(-n_ins // m_b)):
        sel = order[b * m_b : (b + 1) * m_b]
        valid = (b * m_b + iota_b) < n_ins
        row_ls = _cluster_ls_of(recv, sel, n_features)
        row_n = torch.where(valid, recv.n[sel], 0)
        state, assigned, _enc = _batch_step_impl(
            state, *_prep_buffer_rows(row_ls, row_n), threshold, tolerance,
            criterion=criterion, block=block, max_rounds=max_rounds,
            narrow=m_b // 4,
        )
        state, _ = _split_topk_impl(state, k=split_k, fanout=fanout)
        placed = valid & (assigned >= 0)
        amap[torch.where(placed, sel, rc)] = torch.where(placed, assigned, -1)
    return state, amap[:rc], n_ins


def _merge_into_impl(
    state: BatchState,
    recv: BatchState,
    gate: torch.Tensor,  # () f32 group-similarity gate
    threshold: torch.Tensor,
    tolerance: torch.Tensor,
    *,
    m_b: int,
    criterion: str,
    block: int,
    max_rounds: int,
    split_k: int,
    fanout: int,
) -> tuple[BatchState, torch.Tensor, dict[str, int]]:
    r"""Merge a received forest into ``state`` (both on one device).

    Group-gated: received groups whose best own-group centroid similarity is
    below ``gate`` bulk-append (tiles move as whole blocks); the rest insert
    row-level through the batch-step rounds.  Returns the state (its tables
    updated in place), the assignment map of received slot -> own slot (-1
    where the slot is not live or could not be placed yet) and the counts
    ``far``, ``close`` (received groups) and ``rows`` (inserted row-level).

    The appended groups, slots and pool rows take consecutive ids after
    the receiver's own, in the sender's order, so the append is a few
    gathers into table slices; the host sizes the tables beforehand.
    """
    c_cap = state.n.shape[0]
    g_cap = state.g_ls.shape[0]
    p_cap = state.ls.shape[0]
    tile = state.t_pk.shape[1]
    rg_cap = recv.g_ls.shape[0]
    rc_cap = recv.n.shape[0]
    dev = state.n.device
    g_num, num, num_ls = (
        int(x) for x in _host(torch.stack([state.g_num, state.num, state.num_ls]))
    )

    giota = torch.arange(rg_cap, dtype=_I32, device=dev)
    live_r = (giota < recv.g_num) & (recv.g_count > 0)
    best_sim = _best_group_sim(
        recv.g_cent, recv.g_pops, state.g_cent, state.g_pops, g_num, block
    )
    far = live_r & (best_sim < gate)
    close = live_r & (best_sim >= gate)

    # ---- bulk append far groups (whole tiles, no per-row work) ----
    occ = recv.t_slot >= 0  # (RG_cap, tile)
    cell_mask = (far[:, None] & occ).reshape(-1)
    far_idx = _nonzero(far)
    cell_idx = _nonzero(cell_mask)  # row-major: the sender's cell order
    n_far, n_cells = far_idx.shape[0], cell_idx.shape[0]
    src_slot = recv.t_slot.reshape(-1)[cell_idx].long()
    src_ref = recv.ls_ref[src_slot]
    pool_idx = _nonzero(src_ref >= 0)
    n_pool = pool_idx.shape[0]
    if (
        g_num + n_far > g_cap - 1
        or num + n_cells > c_cap - 1
        or num_ls + n_pool > p_cap - 1
    ):
        raise RuntimeError(
            "sharded merge: the receiver's tables are too small for the "
            f"append ({g_num}+{n_far} groups of {g_cap}, {num}+{n_cells} "
            f"slots of {c_cap}, {num_ls}+{n_pool} pool rows of {p_cap})"
        )
    far_rank = _icumsum(far.to(_I32)) - 1  # (RG_cap,) rank among far groups
    cell_rank = far_rank[cell_idx // tile]
    cell_pos = (cell_idx % tile).to(_I32)
    new_slot = num + torch.arange(n_cells, dtype=_I32, device=dev)
    new_ref = torch.full((n_cells,), -1, dtype=_I32, device=dev)
    new_ref[pool_idx] = num_ls + torch.arange(n_pool, dtype=_I32, device=dev)

    slots = slice(num, num + n_cells)
    state.group[slots] = g_num + cell_rank
    state.pos[slots] = cell_pos
    state.n[slots] = recv.n[src_slot]
    state.ls_ref[slots] = new_ref
    state.ls[num_ls : num_ls + n_pool] = recv.ls[src_ref[pool_idx].long()]
    # Tiles copy wholesale; slot cells remap to the fresh slot ids
    remap = torch.full((n_far, tile), -1, dtype=_I32, device=dev)
    remap[cell_rank.long(), cell_pos.long()] = new_slot
    groups = slice(g_num, g_num + n_far)
    state.t_pk[groups] = recv.t_pk[far_idx]
    state.t_pops[groups] = recv.t_pops[far_idx]
    state.t_slot[groups] = remap
    state.g_ls[groups] = recv.g_ls[far_idx]
    state.g_n[groups] = recv.g_n[far_idx]
    state.g_cent[groups] = recv.g_cent[far_idx]
    state.g_pops[groups] = recv.g_pops[far_idx]
    state.g_count[groups] = recv.g_count[far_idx]

    amap = torch.full((rc_cap,), -1, dtype=_I32, device=dev)
    amap[src_slot] = new_slot
    state = state._replace(
        num_ls=state.num_ls + n_pool,
        num=state.num + n_cells,
        g_num=state.g_num + n_far,
    )

    # ---- row-level insert the close groups' member clusters ----
    ciota = torch.arange(rc_cap, dtype=_I32, device=dev)
    ins_mask = (ciota < recv.num) & (recv.n > 0) & close[recv.group.long()]
    n_close = _host_int(_isum(close))
    state, amap, n_rows = _insert_slots_impl(
        state, recv, ins_mask, amap, threshold, tolerance, m_b=m_b,
        criterion=criterion, block=block, max_rounds=max_rounds,
        split_k=split_k, fanout=fanout,
    )
    return state, amap, {"far": n_far, "close": n_close, "rows": n_rows}


def _merge_retry_impl(
    state: BatchState,
    recv: BatchState,
    amap: torch.Tensor,
    threshold: torch.Tensor,
    tolerance: torch.Tensor,
    **kw: tp.Any,
) -> tuple[BatchState, torch.Tensor, int]:
    r"""Re-insert the live received slots that are still unmapped."""
    ciota = torch.arange(recv.n.shape[0], dtype=_I32, device=recv.n.device)
    ins = (ciota < recv.num) & (recv.n > 0) & (amap < 0)
    return _insert_slots_impl(state, recv, ins, amap, threshold, tolerance, **kw)


def _state_to(state: BatchState, device: torch.device) -> BatchState:
    r"""The whole state on ``device`` (the same tensors when it is there)."""
    return BatchState(*(t.to(device, non_blocking=True) for t in state))


def _pull(tensors: tp.Sequence[torch.Tensor]) -> np.ndarray:
    r"""Equal-shaped tensors of several shards as one stacked host array,
    in one read (gathered on the first one's device)."""
    dev = tensors[0].device
    return _host(torch.stack([t.to(dev) for t in tensors]))


class ShardedForest:
    r"""Host side of the sharded engine: one batched CF-forest per mesh
    shard, merged pairwise after the fit.

    ``states`` holds one :class:`BatchState` per shard on the shard's
    device (``None`` once a shard has sent its state in the merge).  The
    host control plane mirrors ``BatchTree``: up to ``pipeline_depth``
    windows stay queued with submit-time sync payloads, capacity grows on
    demand (uniform over the live shards), and rare pending rows retry at
    boundaries.  Refinement (``refine_inplace``) and reclustering re-insert
    surviving clusters as sharded CF buffers and re-run the merge.
    """

    def __init__(
        self,
        n_features: int,
        mesh: Mesh,
        *,
        threshold: float = 0.65,
        merge_criterion: str = "diameter",
        tolerance: float = 0.05,
        merge_criterion_merge: str | None = None,
        merge_threshold_change: float = 0.0,
        merge_gate_margin: float = 0.15,
        batch_size: int = 1024,
        scan_batches: int = 16,
        fanout: int | None = None,
        tile: int = 256,
        initial_capacity: int = 8192,
        ls_capacity: int | None = None,
        g_capacity: int | None = None,
        route_block: int = 1024,
        max_rounds: int = 24,
        pipeline_depth: int = 3,
        resident_input_bytes: int = 4 << 30,
        stage_windows: int = 8,
    ) -> None:
        if fanout is None:
            fanout = min(192, tile * 3 // 4)
        if fanout >= tile:
            raise ValueError("fanout must be < tile (headroom for creations)")
        self.n_features = n_features
        self.n_bytes = (n_features + 7) // 8
        self.mesh = mesh
        self.devices = mesh.devices
        self.n_devices = mesh.size
        self.threshold = threshold
        self.merge_criterion = merge_criterion
        self.tolerance = tolerance
        self.merge_criterion_merge = (
            merge_criterion_merge
            if merge_criterion_merge is not None
            else merge_criterion
        )
        self.merge_threshold = threshold + merge_threshold_change
        self._merge_threshold_change = merge_threshold_change
        self.merge_gate_margin = merge_gate_margin
        self.batch_size = batch_size
        self.scan_batches = scan_batches
        self.fanout = fanout
        self.tile = tile
        self.route_block = route_block
        self.max_rounds = max_rounds
        # Host-side constants as the JAX engine has them (tuned for its
        # TPU; pipeline_depth decides when pending rows are retried, so
        # changing it changes labels).  Windows queued before the oldest
        # boundary settles:
        self.pipeline_depth = max(1, pipeline_depth)
        # Inputs of at most this many bytes (and every tensor input) are
        # staged whole on the mesh; larger ones stream in chunks of
        # `stage_windows` windows
        self.resident_input_bytes = resident_input_bytes
        self.stage_windows = max(1, stage_windows)
        self.split_k = 64

        self.capacity = _next_pow2(max(initial_capacity, 2 * batch_size + 1))
        self.ls_capacity = _next_pow2(
            ls_capacity
            if ls_capacity is not None
            else max(min(self.capacity // 4, 1 << 17), 2 * batch_size + 1)
        )
        # Same sizing rule as BatchTree: steady-state group need plus one
        # scan window's split/creation headroom.  Every group holds at least
        # one slot, so 2 * capacity bounds what a capacity-sized slot table
        # can need (the group table also grows on demand)
        self.g_capacity = _next_pow2(
            g_capacity
            if g_capacity is not None
            else max(
                256,
                min(
                    self.capacity * 13 // (10 * max(fanout, 1))
                    + self._scan_g_headroom(),
                    2 * self.capacity,
                ),
            )
        )
        self.states: list[BatchState | None] = self._init_states()
        # Counters (num, g_num, num_ls) of shards freed by the merge: they
        # stay in the maxima that size the live shards' tables
        self._freed: dict[int, np.ndarray] = {}
        # Host-side per-shard upper bounds (uniform capacity => track max)
        self._num_upper = 0
        self._g_upper = 1
        self._ls_upper = 0
        # Window bookkeeping (host): each entry maps window rows back to
        # molecule ids.  kind == "fps": one singleton row per input row,
        # ``mols`` is a (D, rows_per_shard) int64 id array (-1 pads); kind ==
        # "buffers": pre-aggregated CF rows, ``mols`` is a per-shard list
        # of per-row mol-id lists
        self._windows: list[dict] = []
        self._boundary_queue: list[dict] = []
        self._total_rows = 0
        self._n_mols = 0
        self._merged = False
        self._round_maps: list[tuple[int, dict[int, np.ndarray]]] = []
        # Telemetry: table growths so far, and per merge round the stride,
        # per receiver the received groups appended (far) / gated to the
        # row-level path (close) and the rows inserted, and the retries
        self.growths = 0
        self.merge_stats: list[dict] = []

    # -- states and capacity -------------------------------------------------

    def _init_states(self) -> list[BatchState | None]:
        return [
            _init_state(
                self.capacity, self.g_capacity, self.tile, self.n_features,
                self.ls_capacity, dev,
            )
            for dev in self.devices
        ]

    def _live(self) -> list[tuple[int, BatchState]]:
        return [(i, s) for i, s in enumerate(self.states) if s is not None]

    def _scalars(self, dev: torch.device, threshold: float | None = None):
        f32 = dict(dtype=torch.float32, device=dev)
        thr = self.threshold if threshold is None else threshold
        return torch.tensor(thr, **f32), torch.tensor(self.tolerance, **f32)

    def _counters(self) -> np.ndarray:
        r"""(D, 3) host array of every shard's (num, g_num, num_ls); a freed
        shard keeps the counters it had when it sent its state."""
        live = self._live()
        flat = _pull(
            [torch.stack([s.num, s.g_num, s.num_ls]) for _i, s in live]
        )
        out = np.zeros((self.n_devices, 3), np.int64)
        for row, (i, _s) in zip(flat, live):
            out[i] = row
        for i, row in self._freed.items():
            out[i] = row
        return out

    def _grow(self, new_c: int, new_g: int, new_p: int) -> None:
        for i, s in self._live():
            self.states[i] = _grow_state(s, new_c, new_g, new_p)
        self.capacity, self.g_capacity, self.ls_capacity = new_c, new_g, new_p
        self.growths += 1

    def _scan_g_headroom(self) -> int:
        r"""Free group slots demanded before a window dispatches (see
        ``BatchTree._scan_g_headroom``)."""
        k, m = self.scan_batches, self.batch_size
        return 2 * k * (self.split_k + 4 * (m // self.tile + 4))

    def _ensure_capacity(
        self,
        incoming: int,
        g_incoming: int | None = None,
        p_incoming: int | None = None,
    ) -> None:
        r"""Grow (uniform over the shards) using host upper bounds; exact
        counts are read only near the capacity edge.  Group and pool
        headroom are bounded separately (see ``BatchTree._ensure_capacity``):
        the step's in-table guards leave unplaceable rows pending and the
        boundary grows + retries."""
        if g_incoming is None:
            g_incoming = incoming
        if p_incoming is None:
            p_incoming = incoming
        if (
            self._num_upper + incoming + 1 > self.capacity
            or self._g_upper + g_incoming + 1 > self.g_capacity
            or self._ls_upper + p_incoming + 1 > self.ls_capacity
        ):
            top = self._counters().max(axis=0)
            if self._num_upper + incoming + 1 > self.capacity:
                self._num_upper = int(top[0])
            if self._g_upper + g_incoming + 1 > self.g_capacity:
                self._g_upper = int(top[1])
            if self._ls_upper + p_incoming + 1 > self.ls_capacity:
                self._ls_upper = int(top[2])
        self._reserve(
            self._num_upper + incoming + 1,
            self._g_upper + g_incoming + 1,
            self._ls_upper + p_incoming + 1,
        )

    def _reserve(self, need_c: int, need_g: int, need_p: int) -> None:
        r"""Grow (uniform over the shards) until the tables hold at least
        this many slots, groups and pool rows."""
        new_c, new_g, new_p = self.capacity, self.g_capacity, self.ls_capacity
        while new_c < need_c:
            new_c *= 2
        while new_g < need_g:
            new_g *= 2
        while new_p < need_p:
            new_p *= 2
        if (new_c, new_g, new_p) != (
            self.capacity, self.g_capacity, self.ls_capacity
        ):
            self._grow(new_c, new_g, new_p)

    def _step_kw(self, criterion: str | None = None) -> dict[str, tp.Any]:
        return dict(
            criterion=self.merge_criterion if criterion is None else criterion,
            block=self.route_block, max_rounds=self.max_rounds,
        )

    # -- fit -----------------------------------------------------------------

    def warm_programs(self, packed_fps: tp.Any = None) -> None:
        r"""Run every shard's hot steps once with mass-less inputs: a retry
        step and ``max(2, pipeline_depth)`` zero-valid scan windows (the
        forest's state is unchanged, bar the split checks a window runs
        anyway).

        PyTorch runs eagerly, so there is nothing to compile: on a card
        this builds (or loads) the kernels and warms the caching allocator
        with the working set of a step.  ``packed_fps`` is accepted for
        the JAX engine's signature and is not read.
        """
        m, k = self.batch_size, self.scan_batches
        for i, st in self._live():
            dev = self.devices[i]
            if dev.type == "cuda":
                tile_search._lib()
            buf = torch.zeros((k * m, self.n_bytes), dtype=torch.uint8, device=dev)
            thr, tol = self._scalars(dev)
            for _ in range(max(2, self.pipeline_depth)):
                st, _a, _e = _scan_fit_packed_impl(
                    st, buf, 0, 0, thr, tol, k=k, m=m,
                    n_features=self.n_features, narrow=m // 4,
                    split_k=self.split_k, fanout=self.fanout, **self._step_kw(),
                )
            rows = _slice_prep_fp_rows_impl(buf, 0, 0, m, self.n_features)
            st, _a, _e = _batch_step_impl(
                st, *rows, thr, tol, narrow=m // 4, **self._step_kw()
            )
            self.states[i] = st
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def _window_blocks(self, buf: torch.Tensor) -> list[torch.Tensor]:
        r"""Cut a window-major ``(n_w, window, F8)`` buffer into one
        ``(n_w, window / D, F8)`` block per shard, on the shard's device: a
        view where the buffer already lies there, else one copy."""
        win_d = buf.shape[1] // self.n_devices
        return [
            buf[:, i * win_d : (i + 1) * win_d].to(dev, non_blocking=True)
            for i, dev in enumerate(self.devices)
        ]

    def fit_packed(
        self,
        packed_fps: "np.ndarray | torch.Tensor",
        mol_indices: "tp.Sequence[int] | np.ndarray | None" = None,
    ) -> None:
        r"""Insert packed fingerprint rows sharded over the mesh.

        A tensor, or a host array of at most ``resident_input_bytes``, goes
        to the mesh's first device whole, is padded there to whole windows
        and cut into per-shard blocks.  Otherwise (``packed_fps`` may be a
        file mapping) rows stream in chunks of ``stage_windows`` windows of
        ``D * scan_batches * batch_size`` rows, so host memory is bounded by
        the chunk.  Row-to-shard assignment and batch composition are
        identical on both paths, so labels are too.  Rows are assigned to
        shards in contiguous per-window blocks; labels compose at
        :meth:`merge`.  ``mol_indices`` defaults to sequential ids
        continuing from the rows already inserted (refinement passes the
        exploded rows' original ids).
        """
        if self._merged:
            raise RuntimeError("cannot insert after merge()")
        if len(packed_fps) and packed_fps.shape[-1] != self.n_bytes:
            raise ValueError(
                f"packed rows have {packed_fps.shape[-1]} bytes, expected "
                f"{self.n_bytes} for {self.n_features} features"
            )
        d = self.n_devices
        m, k = self.batch_size, self.scan_batches
        win_d = k * m  # rows per shard per window
        window = d * win_d
        num = len(packed_fps)
        if mol_indices is None:
            mol_arr = np.arange(
                self._total_rows, self._total_rows + num, dtype=np.int64
            )
        else:
            mol_arr = (
                np.asarray(mol_indices, dtype=np.int64)
                if isinstance(mol_indices, np.ndarray)
                else np.fromiter(mol_indices, dtype=np.int64)
            )
            if len(mol_arr) != num:
                raise ValueError(
                    f"mol_indices has {len(mol_arr)} entries for {num} "
                    "packed rows -- ids would misalign with their rows"
                )
        if num:
            self._n_mols = max(self._n_mols, int(mol_arr.max()) + 1)

        def meta(start: int):
            stop = min(start + window, num)
            mols = mol_arr[start:stop]
            if stop - start < window:
                mols = np.pad(
                    mols, (0, window - (stop - start)), constant_values=-1
                )
            valids = np.clip(
                (stop - start) - win_d * np.arange(d), 0, win_d
            ).astype(np.int32)
            return valids, mols.reshape(d, win_d)

        first = self.devices[0]
        on_device = isinstance(packed_fps, torch.Tensor)
        if num and (on_device or num * self.n_bytes <= self.resident_input_bytes):
            buf = (
                packed_fps.to(first, torch.uint8)
                if on_device
                else _upload(np.asarray(packed_fps, dtype=np.uint8), first)
            )
            # Pad on the device, so that every window -- a partial tail
            # too -- is a slice of the resident buffer
            n_res = -(-num // window)
            blocks = self._window_blocks(
                _pad_rows(buf, n_res * window).reshape(n_res, window, self.n_bytes)
            )
            del buf
            for wi, start in enumerate(range(0, num, window)):
                self._submit_window(blocks, wi, *meta(start))
        elif num:
            # Chunked streamed staging: each chunk is a window-major buffer
            # of `stage_windows` windows (a single-window input keeps the
            # one-window buffer); only a final partial chunk is padded, on
            # the host
            n_windows = -(-num // window)
            cw = 1 if n_windows <= 1 else self.stage_windows
            chunk_rows = cw * window
            blocks = []
            for wi, start in enumerate(range(0, num, window)):
                if wi % cw == 0:
                    stop = min(start + chunk_rows, num)
                    chunk = np.asarray(packed_fps[start:stop], dtype=np.uint8)
                    if stop - start < chunk_rows:
                        chunk = np.pad(
                            chunk, ((0, chunk_rows - (stop - start)), (0, 0))
                        )
                    blocks = self._window_blocks(
                        _upload(chunk, first).view(cw, window, self.n_bytes)
                    )
                self._submit_window(blocks, wi % cw, *meta(start))
        self._total_rows += num
        self.flush()

    def _submit_window(
        self,
        blocks: list[torch.Tensor],
        w: int,
        valids: np.ndarray,
        mols: np.ndarray,
    ) -> None:
        r"""Run window ``w`` of the shards' staged blocks on every shard
        (a shard with no valid row still runs the window's split checks)
        and queue the boundary."""
        m, k = self.batch_size, self.scan_batches
        # p_incoming=0: pool allocations are guarded in-step (see
        # BatchTree._submit_scan)
        self._ensure_capacity(
            k * m, g_incoming=self._scan_g_headroom(), p_incoming=0
        )
        assigned, syncs = [], []
        for i, st in self._live():
            thr, tol = self._scalars(self.devices[i])
            st, a, encs = _scan_fit_packed_impl(
                st, blocks[i][w], 0, int(valids[i]), thr, tol, k=k, m=m,
                n_features=self.n_features, narrow=m // 4,
                split_k=self.split_k, fanout=self.fanout, **self._step_kw(),
            )
            self.states[i] = st
            assigned.append(a.reshape(-1))
            # Submit-time sync payload (a snapshot: later windows update
            # the tables in place): the window's encs plus the shard's
            # counters as of this window, read when the boundary settles
            syncs.append(
                torch.cat([encs, torch.stack([st.num, st.g_num, st.num_ls])])
            )
        n_valid = int(valids.max(initial=0))
        self._num_upper += n_valid
        # _ls_upper intentionally not advanced: the in-step pool guard
        # makes over-allocation impossible and flush() refreshes the bound
        self._g_upper += k * self.split_k + max(
            16, 4 * (n_valid // self.tile + 1)
        )
        self._windows.append(
            {"kind": "fps", "assigned": assigned, "valids": valids, "mols": mols}
        )
        self._boundary_queue.append(
            {
                "kind": "fps",
                "win_idx": len(self._windows) - 1,
                "blocks": blocks,
                "w": w,
                "valids": valids,
                "enc_cols": k,
                "sync": syncs,
            }
        )
        while len(self._boundary_queue) > self.pipeline_depth:
            self._process_oldest_boundary()

    def insert_buffers(
        self,
        buffers: np.ndarray,
        mol_index_seqs: tp.Sequence[tp.Sequence[int]],
    ) -> None:
        r"""Insert pre-aggregated CF buffers ``[linear_sum..., n]`` sharded
        over the mesh (contiguous per-shard blocks, one batch step + split
        pass per shard per window): the sharded twin of
        ``BatchTree.insert_buffers``; refinement re-inserts surviving
        clusters through this path."""
        if self._merged:
            raise RuntimeError("cannot insert after merge()")
        d, m = self.n_devices, self.batch_size
        window = d * m
        buffers = np.asarray(buffers)
        ls = buffers[:, :-1].astype(np.int32)
        ns = buffers[:, -1].astype(np.int32)
        mols = [list(s) for s in mol_index_seqs]
        if mols:
            self._n_mols = max(
                self._n_mols,
                max((max(s, default=-1) for s in mols), default=-1) + 1,
            )
        num = len(ls)
        for start in range(0, num, window):
            stop = min(start + window, num)
            chunk_ls = ls[start:stop]
            chunk_n = ns[start:stop]
            pad = window - (stop - start)
            if pad:
                chunk_ls = np.pad(chunk_ls, ((0, pad), (0, 0)))
                chunk_n = np.pad(chunk_n, (0, pad))
            valids = np.clip(
                (stop - start) - m * np.arange(d), 0, m
            ).astype(np.int32)
            mol_chunk = mols[start:stop] + [[] for _ in range(pad)]
            self._submit_buffer_window(
                [
                    _upload(chunk_ls[i * m : (i + 1) * m], dev)
                    for i, dev in enumerate(self.devices)
                ],
                [
                    _upload(chunk_n[i * m : (i + 1) * m], dev)
                    for i, dev in enumerate(self.devices)
                ],
                valids,
                [mol_chunk[i * m : (i + 1) * m] for i in range(d)],
            )
        self.flush()

    def _buffer_steps(
        self, dev_ls: list[torch.Tensor], dev_n: list[torch.Tensor],
        missing: np.ndarray,
    ) -> tuple[list[torch.Tensor | None], list[torch.Tensor]]:
        r"""One batch step of the masked CF rows on every shard that has
        one, then a split pass on every shard.  Returns the per-shard
        assigned slots (None where no row was masked in) and encs."""
        m = self.batch_size
        assigned: list[torch.Tensor | None] = []
        encs = []
        for i, st in self._live():
            dev = self.devices[i]
            a, enc = None, torch.zeros((), dtype=_I32, device=dev)
            if missing[i].any():
                thr, tol = self._scalars(dev)
                n_eff = torch.where(
                    torch.from_numpy(missing[i]).to(dev), dev_n[i], 0
                )
                st, a, enc = _batch_step_impl(
                    st, *_prep_buffer_rows(dev_ls[i], n_eff), thr, tol,
                    narrow=m // 4, **self._step_kw(),
                )
            st, _ = _split_topk_impl(st, k=self.split_k, fanout=self.fanout)
            self.states[i] = st
            assigned.append(a)
            encs.append(enc)
        return assigned, encs

    def _submit_buffer_window(
        self,
        dev_ls: list[torch.Tensor],
        dev_n: list[torch.Tensor],
        valids: np.ndarray,
        mols: list[list[list[int]]],
    ) -> None:
        m = self.batch_size
        n_valid = int(valids.max(initial=0))
        # CF rows can all demand pool rows (multi-member clusters), so the
        # pool headroom is bounded up-front here, unlike the fps path
        self._ensure_capacity(
            m, g_incoming=self.split_k + 4 * (m // self.tile + 4),
            p_incoming=m,
        )
        missing = np.arange(m)[None, :] < valids[:, None]
        assigned, encs = self._buffer_steps(dev_ls, dev_n, missing)
        syncs = [
            torch.stack([enc, st.num, st.g_num, st.num_ls])
            for enc, (_i, st) in zip(encs, self._live())
        ]
        self._num_upper += n_valid
        self._ls_upper += n_valid
        self._g_upper += self.split_k + max(
            16, 4 * (n_valid // self.tile + 1)
        )
        self._windows.append(
            {
                "kind": "buffers",
                "assigned": [
                    a if a is not None
                    else torch.full((m,), -1, dtype=_I32, device=dev)
                    for a, dev in zip(assigned, self.devices)
                ],
                "valids": valids,
                "mols": mols,
            }
        )
        self._boundary_queue.append(
            {
                "kind": "buffers",
                "win_idx": len(self._windows) - 1,
                "dev_ls": dev_ls,
                "dev_n": dev_n,
                "valids": valids,
                "enc_cols": 1,
                "sync": syncs,
            }
        )
        while len(self._boundary_queue) > self.pipeline_depth:
            self._process_oldest_boundary()

    def flush(self) -> None:
        r"""Drain every deferred boundary, then a split pass."""
        while self._boundary_queue:
            self._process_oldest_boundary()
        self._split_drain(drain=False)

    def _process_oldest_boundary(self) -> None:
        r"""Pop and settle the OLDEST deferred boundary (see
        ``BatchTree._process_oldest_boundary``): one read of the entry's
        submit-time sync payloads, the counter bounds refreshed from them,
        and the window's pending rows retried."""
        q = self._boundary_queue.pop(0)
        k = self.scan_batches
        flat = _pull(q["sync"])  # (D, enc_cols + 3)
        pending = flat[:, : q["enc_cols"]] // 1000
        # True per-shard counters as of this window, plus the worst-case
        # contributions of the newer windows already run
        extra_rows = extra_g = 0
        for q2 in self._boundary_queue:
            nv2 = int(q2["valids"].max(initial=0))
            extra_rows += nv2
            extra_g += (k if q2["kind"] == "fps" else 1) * self.split_k + max(
                16, 4 * (nv2 // self.tile + 1)
            )
        self._num_upper = int(flat[:, -3].max()) + extra_rows
        self._g_upper = int(flat[:, -2].max()) + extra_g
        # fps windows are not charged per-row against the pool (the
        # in-step guard pends on exhaustion -- see the BatchTree twin);
        # buffer windows CAN all take pool rows, so they charge fully
        extra_pool = sum(
            int(q2["valids"].max(initial=0))
            if q2["kind"] == "buffers"
            else 2 * self.batch_size
            for q2 in self._boundary_queue
        )
        self._ls_upper = int(flat[:, -1].max()) + extra_pool
        # Proactive pool headroom while the counters are fresh
        self._ensure_capacity(0, g_incoming=0, p_incoming=2 * self.batch_size)
        if (pending > 0).any():
            if q["kind"] == "fps":
                self._retry_window(q, pending)
            else:
                self._retry_buffer_window(q)
            self._split_drain(drain=False)

    def _split_drain(self, drain: bool) -> None:
        r"""A split pass on every shard (a pass changes a shard whether or
        not it has rows pending); ``drain`` repeats until no shard has an
        oversized group left."""
        k = self.split_k
        for _ in range(64):
            self._ensure_capacity(k)
            n_left = []
            for i, st in self._live():
                self.states[i], left = _split_topk_impl(
                    st, k=k, fanout=self.fanout
                )
                n_left.append(left)
            self._g_upper += k
            if not drain or int(_pull(n_left).max()) <= 0:
                return

    def _assigned_host(self, win: dict) -> np.ndarray:
        r"""(D, rows) host array of a window's assigned slots."""
        if not isinstance(win["assigned"], np.ndarray):
            win["assigned"] = np.stack([_host(a) for a in win["assigned"]])
        return win["assigned"]

    def _retry_window(self, q: dict, pending: np.ndarray) -> None:
        r"""Drain a window whose scan left pending rows on some shard
        (rare): split fully, then masked re-steps per affected batch on
        the shards that miss rows."""
        m, k = self.batch_size, self.scan_batches
        win = self._windows[q["win_idx"]]
        valids = win["valids"]
        final = np.array(self._assigned_host(win))  # (D, k*m)
        valid_rows = np.arange(k * m)[None, :] < valids[:, None]
        for i in range(k):
            if not (pending[:, i] > 0).any():
                continue
            seg = slice(i * m, (i + 1) * m)
            for _attempt in range(64):
                missing = (final[:, seg] == -1) & valid_rows[:, seg]
                if not missing.any():
                    break
                self._split_drain(drain=True)
                self._ensure_capacity(m)
                nv = np.clip(valids - i * m, 0, m)
                for dv, st in self._live():
                    if not missing[dv].any():
                        continue  # a mass-less step changes nothing
                    dev = self.devices[dv]
                    thr, tol = self._scalars(dev)
                    row_ls, row_n, row_cent, row_pk, row_pop = (
                        _slice_prep_fp_rows_impl(
                            q["blocks"][dv][q["w"]], i * m, int(nv[dv]), m,
                            self.n_features,
                        )
                    )
                    row_n = torch.where(
                        torch.from_numpy(missing[dv]).to(dev), row_n, 0
                    )
                    self.states[dv], assigned, _enc = _batch_step_impl(
                        st, row_ls, row_n, row_cent, row_pk, row_pop, thr,
                        tol, narrow=m // 4, **self._step_kw(),
                    )
                    final[dv, seg][missing[dv]] = _host(assigned)[missing[dv]]
                n_miss = int(missing.sum(1).max(initial=0))
                self._num_upper += n_miss
                self._g_upper += n_miss
                self._ls_upper += n_miss
            else:
                raise RuntimeError("sharded engine failed to drain a window")
        win["assigned"] = final

    def _retry_buffer_window(self, q: dict) -> None:
        r"""Drain a buffer window whose step left pending CF rows on some
        shard (rare): split fully, then masked re-steps until placed."""
        m = self.batch_size
        win = self._windows[q["win_idx"]]
        final = np.array(self._assigned_host(win))  # (D, m)
        valid_rows = np.arange(m)[None, :] < win["valids"][:, None]
        for _attempt in range(64):
            missing = (final == -1) & valid_rows
            if not missing.any():
                break
            self._split_drain(drain=True)
            self._ensure_capacity(m, p_incoming=m)
            assigned, _encs = self._buffer_steps(q["dev_ls"], q["dev_n"], missing)
            n_miss = int(missing.sum(1).max(initial=0))
            self._num_upper += n_miss
            self._g_upper += n_miss + self.split_k
            self._ls_upper += n_miss
            for dv, a in enumerate(assigned):
                if a is not None:
                    final[dv][missing[dv]] = _host(a)[missing[dv]]
        else:
            raise RuntimeError("sharded engine failed to drain a buffer window")
        win["assigned"] = final

    # -- merge ---------------------------------------------------------------

    def merge(self) -> None:
        r"""Run the ``ceil(log2(D))`` reduction rounds; shard 0 ends up
        holding the global forest.  Idempotent."""
        if self._merged:
            return
        self.flush()
        self._split_drain(drain=True)
        d = self.n_devices
        if d > 1:
            gate = float(
                np.clip(self.merge_threshold - self.merge_gate_margin, 0.0, 1.0)
            )
            m_b = self.batch_size
            kw = dict(
                m_b=m_b, split_k=self.split_k, fanout=self.fanout,
                **self._step_kw(self.merge_criterion_merge),
            )
            for r in range(math.ceil(math.log2(d))):
                stride = 1 << r
                receivers = [
                    s - stride for s in range(d) if s % (2 * stride) == stride
                ]
                # Uniform capacity: the worst pair must fit own + received
                nums, gnums, pnums = self._counters().T
                need_c = need_g = need_p = 0
                for recv_d in receivers:
                    s = recv_d + stride
                    need_c = max(need_c, int(nums[recv_d] + nums[s]))
                    need_g = max(
                        need_g,
                        int(
                            gnums[recv_d] + gnums[s]
                            + nums[s] // self.tile + self.split_k + 16
                        ),
                    )
                    need_p = max(
                        need_p, int(pnums[recv_d] + pnums[s] + nums[s])
                    )
                self._num_upper = need_c
                self._g_upper = need_g
                self._ls_upper = need_p
                growths0 = self.growths
                self._ensure_capacity(m_b + 1)
                # _ensure_capacity re-reads a counter whose bound is past
                # the table and so may settle for less than the pair needs
                # (the JAX engine stops there and drops what does not fit):
                # the append must fit below the guard slots
                self._reserve(need_c + 1, need_g + 1, need_p + 1)
                # Exchange: the sender's state moves to its partner's device
                # and the sender is freed (it never receives again); the
                # received copy keeps its capacity if the states grow below
                recvs: dict[int, BatchState] = {}
                for recv_d in receivers:
                    s = recv_d + stride
                    recvs[recv_d] = _state_to(
                        tp.cast(BatchState, self.states[s]), self.devices[recv_d]
                    )
                    self._freed[s] = np.array([nums[s], gnums[s], pnums[s]])
                    self.states[s] = None
                amaps: dict[int, torch.Tensor] = {}
                stats: dict[int, dict[str, int]] = {}
                for recv_d in receivers:
                    dev = self.devices[recv_d]
                    thr, tol = self._scalars(dev, self.merge_threshold)
                    self.states[recv_d], amaps[recv_d], stats[recv_d] = (
                        _merge_into_impl(
                            tp.cast(BatchState, self.states[recv_d]),
                            recvs[recv_d],
                            torch.tensor(gate, dtype=torch.float32, device=dev),
                            thr, tol, **kw,
                        )
                    )
                # Retry until every live received slot is mapped (capacity
                # growth is the usual reason a slot pends)
                retries = 0
                for _attempt in range(64):
                    amap_np = {
                        recv_d: _host(amaps[recv_d]) for recv_d in receivers
                    }
                    missing = [
                        recv_d for recv_d in receivers
                        if (amap_np[recv_d][: int(nums[recv_d + stride])] < 0).any()
                    ]
                    if not missing:
                        break
                    retries += 1
                    # Sync true counts: overflow-chunk creations during the
                    # insert loop can outrun the host's loose upper bounds,
                    # and a stale bound here would skip the growth the
                    # pending rows are waiting for
                    top = self._counters().max(axis=0)
                    self._num_upper = int(top[0])
                    self._g_upper = int(top[1])
                    self._ls_upper = int(top[2])
                    self._ensure_capacity(2 * m_b)
                    for recv_d in missing:
                        thr, tol = self._scalars(
                            self.devices[recv_d], self.merge_threshold
                        )
                        self.states[recv_d], amaps[recv_d], n_rows = (
                            _merge_retry_impl(
                                tp.cast(BatchState, self.states[recv_d]),
                                recvs[recv_d], amaps[recv_d], thr, tol, **kw,
                            )
                        )
                        stats[recv_d]["rows"] += n_rows
                else:
                    raise RuntimeError(
                        "sharded merge failed to place every received row"
                    )
                del recvs
                self._round_maps.append((stride, amap_np))
                self.merge_stats.append(
                    {
                        "stride": stride,
                        "receivers": stats,
                        "retries": retries,
                        "growths": self.growths - growths0,
                    }
                )
        self._merged = True

    # -- extraction ----------------------------------------------------------

    def labels(self) -> np.ndarray:
        r"""Final cluster slot per molecule id (composed on the host).

        The output is indexed by MOLECULE id: sequential fits produce one
        row per input row in order; after :meth:`refine_inplace` the ids
        still address the original input rows (surviving clusters carry
        their member ids through the CF-buffer windows).
        """
        self.merge()
        d = self.n_devices
        parts: list[np.ndarray] = []
        dev_parts: list[np.ndarray] = []
        spans: list[tuple[dict, int, int, int]] = []  # (win, shard, a, b)
        pos = 0
        for win in self._windows:
            arr = self._assigned_host(win)
            for dev in range(d):
                nv = int(win["valids"][dev])
                if nv:
                    parts.append(arr[dev, :nv])
                    dev_parts.append(np.full(nv, dev, np.int64))
                    spans.append((win, dev, pos, pos + nv))
                    pos += nv
        if not parts:
            return np.empty(0, np.int64)
        slots = np.concatenate(parts).astype(np.int64)
        dev_of = np.concatenate(dev_parts)
        for stride, maps in self._round_maps:
            for recv_d, amap in maps.items():
                sent = dev_of == recv_d + stride
                if sent.any():
                    slots[sent] = amap[slots[sent]]
                    dev_of[sent] = recv_d
        # Scatter window rows back to molecule ids
        out = np.full(self._n_mols, -1, np.int64)
        for win, dev, a, b in spans:
            if win["kind"] == "fps":
                out[win["mols"][dev, : b - a]] = slots[a:b]
            else:
                row_slots = slots[a:b]
                for i, seq in enumerate(win["mols"][dev][: b - a]):
                    if seq:
                        out[np.asarray(seq, dtype=np.int64)] = row_slots[i]
        return out

    def cluster_mols(self) -> list[list[int]]:
        r"""Molecule ids per merged cluster slot (host-side)."""
        labels = self.labels()
        ncl = self.num_clusters
        present = labels >= 0
        order = np.argsort(labels[present], kind="stable")
        mol_ids = np.flatnonzero(present)[order]
        bounds = np.searchsorted(labels[present][order], np.arange(ncl + 1))
        return [
            mol_ids[bounds[i] : bounds[i + 1]].tolist() for i in range(ncl)
        ]

    # -- refinement ----------------------------------------------------------

    def reset(
        self,
        *,
        threshold: float | None = None,
        merge_criterion: str | None = None,
        tolerance: float | None = None,
        merge_threshold_change: float | None = None,
    ) -> None:
        r"""Clear the forest (all shards), optionally re-parameterized.
        Molecule-id space is preserved so refinement labels stay addressed
        by the original input rows.

        ``merge_threshold_change`` replaces the stored fit->merge threshold
        delta.  Refinement passes 0.0 together with an already-shifted
        ``threshold`` so the reduction rounds run at the SAME refined
        threshold as the fit; without it the stored delta would be applied
        on top of the shifted threshold -- twice in total."""
        self.flush()
        if merge_threshold_change is not None:
            self._merge_threshold_change = merge_threshold_change
        if threshold is not None:
            self.threshold = threshold
        if threshold is not None or merge_threshold_change is not None:
            self.merge_threshold = self.threshold + self._merge_threshold_change
        if merge_criterion is not None:
            self.merge_criterion = merge_criterion
            self.merge_criterion_merge = merge_criterion
        if tolerance is not None:
            self.tolerance = tolerance
        self.states = self._init_states()
        self._freed = {}
        self._num_upper = 0
        self._g_upper = 1
        self._ls_upper = 0
        self._windows = []
        self._boundary_queue = []
        self._round_maps = []
        self._merged = False

    def refine_inplace(
        self,
        X: "np.ndarray | tp.Any",
        initial_mol: int = 0,
        input_is_packed: bool = True,
        n_largest: int = 1,
        *,
        threshold: float | None = None,
        merge_criterion: str | None = None,
        tolerance: float | None = None,
        merge_threshold_change: float | None = None,
    ) -> "ShardedForest":
        r"""Explode the ``n_largest`` merged clusters into singletons and
        re-fit over the mesh.

        Mirrors ``BatchTree.refine_inplace``: surviving clusters re-insert
        as sharded CF buffers largest first, then the exploded rows
        re-insert as sharded singletons (their original fingerprints
        reloaded from ``X`` by molecule id), and the reduction rounds
        re-merge.
        """
        if n_largest < 0:
            raise ValueError("n_largest must be >= 0")
        self.merge()
        sizes = self.cluster_sizes()
        ls = self.linear_sums()
        mols = self.cluster_mols()
        order = np.argsort(-sizes, kind="stable")
        big, rest = order[:n_largest], order[n_largest:]

        exploded_mols = [m for i in big for m in mols[i]]
        rows, row_mols = _load_rows_by_mol(
            X, exploded_mols, initial_mol, input_is_packed
        )
        buffers = np.concatenate(
            [ls[rest], sizes[rest, None]], axis=1, dtype=np.int64
        )
        buffer_mols = [mols[i] for i in rest]

        self.reset(
            threshold=threshold,
            merge_criterion=merge_criterion,
            tolerance=tolerance,
            merge_threshold_change=merge_threshold_change,
        )
        if len(buffers):
            self.insert_buffers(buffers, buffer_mols)
        if len(rows):
            self.fit_packed(rows, np.asarray(row_mols, dtype=np.int64))
        self.merge()
        return self

    def recluster_inplace(
        self,
        iterations: int = 1,
        extra_threshold: float = 0.0,
        shuffle: bool = False,
        seed: int | None = None,
    ) -> "ShardedForest":
        r"""Re-insert every merged cluster as a sharded CF buffer,
        optionally shuffled, bumping the threshold per iteration (the
        sharded twin of ``BatchTree.recluster_inplace``)."""
        rng = np.random.default_rng(seed)
        for _ in range(iterations):
            self.merge()
            sizes = self.cluster_sizes()
            ls = self.linear_sums()
            mols = self.cluster_mols()
            order = (
                rng.permutation(len(sizes))
                if shuffle
                else np.argsort(-sizes, kind="stable")
            )
            buffers = np.concatenate(
                [ls[order], sizes[order, None]], axis=1, dtype=np.int64
            )
            buffer_mols = [mols[i] for i in order]
            self.reset(threshold=self.threshold + extra_threshold)
            self.insert_buffers(buffers, buffer_mols)
            self.merge()
        return self

    @property
    def _merged_state(self) -> BatchState:
        self.merge()
        return tp.cast(BatchState, self.states[0])

    @property
    def num_clusters(self) -> int:
        return _host_int(self._merged_state.num)

    def cluster_sizes(self) -> np.ndarray:
        return _host(self._merged_state.n)[: self.num_clusters]

    def linear_sums(self) -> np.ndarray:
        r"""(C, F) int32 linear sums of the merged forest (shard 0),
        reconstructed from the sparse pool in chunks of 2^15 slots."""
        state = self._merged_state
        ncl = self.num_clusters
        out = np.empty((ncl, self.n_features), np.int32)
        chunk = 1 << 15
        for start in range(0, ncl, chunk):
            size = min(chunk, ncl - start)
            rows = _reconstruct_ls_chunk(state, start, chunk, self.n_features)
            out[start : start + size] = _host(rows)[:size]
        return out

    def state_bytes_per_device(self) -> int:
        r"""Table footprint of one shard (capacity-sized)."""
        state = next(s for _i, s in self._live())
        return sum(t.numel() * t.element_size() for t in state)


def sharded_fit(
    fps: np.ndarray,
    mesh: Mesh | None = None,
    *,
    device: str | torch.device = "cuda",
    input_is_packed: bool = False,
    n_features: int | None = None,
    threshold: float = 0.65,
    merge_criterion: str = "diameter",
    tolerance: float = 0.05,
    merge_criterion_merge: str | None = None,
    merge_threshold_change: float = 0.0,
    merge_gate_margin: float = 0.15,
    batch_size: int = 256,
    scan_batches: int = 16,
    capacity: int | None = None,
    g_capacity: int | None = None,
    fanout: int | None = None,
    tile: int = 256,
    centroid_block: int = 512,
    max_rounds: int = 24,
) -> ShardedClusters:
    r"""Cluster fingerprints data-parallel over a mesh (default: every
    visible device of kind ``device``).

    ``fps`` may be unpacked 0/1 rows or packed bytes (``input_is_packed``),
    including a file mapping -- rows stream through in windows.  Capacity
    defaults grow on demand from the clusters each shard discovers
    (decoupled from the input size).
    """
    if mesh is None:
        mesh = get_mesh(device=device)
    if input_is_packed:
        if n_features is None:
            n_features = fps.shape[1] * 8
        packed = np.asarray(fps, dtype=np.uint8)
    else:
        n_features = fps.shape[1]
        packed = np.packbits(np.asarray(fps, dtype=np.uint8), axis=-1)

    # Spread small inputs over the whole mesh: shrink the scan window so one
    # window's per-shard block does not swallow every row on shard 0
    scan_batches = max(
        1, min(scan_batches, -(-len(packed) // (mesh.size * batch_size)))
    )
    forest = ShardedForest(
        n_features,
        mesh,
        threshold=threshold,
        merge_criterion=merge_criterion,
        tolerance=tolerance,
        merge_criterion_merge=merge_criterion_merge,
        merge_threshold_change=merge_threshold_change,
        merge_gate_margin=merge_gate_margin,
        batch_size=batch_size,
        scan_batches=scan_batches,
        fanout=fanout,
        tile=tile,
        initial_capacity=(
            capacity if capacity is not None else 2 * batch_size + 2
        ),
        g_capacity=g_capacity,
        route_block=centroid_block,
        max_rounds=max_rounds,
    )
    forest.fit_packed(packed)
    forest.merge()
    return ShardedClusters(
        labels=forest.labels(),
        linear_sums=forest.linear_sums(),
        sizes=forest.cluster_sizes(),
        num_clusters=forest.num_clusters,
    )
