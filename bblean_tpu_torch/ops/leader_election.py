r"""The insert round's leader election, with a CUDA kernel on the card and
the plain PyTorch version.

Counterpart of ``bblean_tpu/engine/batch.py:504-540`` (step 4 of JAX's
``_insert_round``), which XLA fuses inside its jitted step: among the
round's rejected rows, each routed group elects as leaders the rows that no
lower rejected row of the group is similar to (or that were struck twice),
and every rejected row that does not lead finds its most similar leader
below it.

Contract.  A pair (j, i) counts where ``i < j``, ``rejected[i]`` and
``row_group[i] == row_group[j]``; its sim is ``sims[j, i]`` (an all-pairs
row Tanimoto) or, where ``sims`` is None, the f32 Tanimoto of the packed
rows ``row_pk`` with popcounts ``row_pop`` (what the round passes).  Then

- ``leads = rejected & (force_lead | ~any(sim >= threshold))`` over the
  counted pairs of each row (and its ``_NEG`` entries, as the plain
  version's (M, M) row has them), on every row;
- on the rows with ``rejected & ~leads``: ``best_lead_sim`` the largest
  sim over the counted pairs whose ``i`` leads, ``_NEG = -2.0`` where
  there is none, and ``lead_of`` the first such ``i`` with that sim, 0
  where there is none (what ``torch.argmax`` gives over a row of
  ``_NEG``).

The kernel's outputs equal the plain version's bit for bit on those rows;
on every other row it writes ``lead_of = 0`` and ``best_lead_sim =
_NEG``, where the plain version computes values the round never reads:
``engine/batch.py::_insert_round`` reads ``best_lead_sim`` only in ``join
= rejected & ~leads & (best_lead_sim >= threshold)`` (``:568``), replaces
``lead_of`` by the row's own index for the leaders (``:570``), and masks
every later read of ``lead_of`` by ``leader | join`` (the cohesion key,
``:575``) or ``join_commit`` (the create guard ``:606``, the fit check
``:631`` and the joining rows' slots ``:643``).  Sims are
Tanimoto values (finite, at least 0).

The plain version (the torch chain of (M, M) planes the engine ran before,
with the int8 Gram of the rejected rows where there are no sims) computes
every row.  The kernel of ``csrc/leader_election.cu`` (``ops/_kernel.py``:
how a wrapper dispatches) takes the packed rows, never ``sims``, and needs
``plan``; ``launches`` counts the calls that launched it (each launches its
three phases: the rejected rows listed by group, the leaders, each
non-leader's best leader).  The kernel lists the rejected rows by group from ``plan``,
the step's sort plan ``(order, skey)``: the step's rows sorted stably by
group, in which every row that may be rejected sits in its group's segment
in row order (a wide round's rows are the step's).  A narrow round's rows
are a selection of the step's and pass ``(order, skey, sel)``, ``sel``
the step row of each of its rows, rising over the rows that may be
rejected (its pending rows, the step's lowest).  The kernel takes the
groups from the plan, which must agree with ``row_group``; its scratch
comes from the wrapper, so a call captures into a CUDA graph.
"""

from __future__ import annotations

import torch

from bblean_tpu_torch.ops import _kernel
from bblean_tpu_torch.ops.packing import unpack_fingerprints_device
from bblean_tpu_torch.ops.tanimoto import _int8_gram, _pad_int8

__all__ = [
    "elect_leaders",
    "elect_leaders_plain",
    "tanimoto_gram",
    "launches",
]

_NEG = -2.0  # below any similarity

# Calls of elect_leaders that launched the kernel
launches = 0
_kernel.count_launches(__name__, "launches")

kernel = _kernel.Kernel(
    "leader-election", "leader_election.cu",
    {
        "bb_leader_election": ("p" * 12 + "i" * 3 + "p", "i"),
        "bb_leader_election_scratch": ("ii", "z"),
    },
)


def tanimoto_gram(
    cent: torch.Tensor, pop: torch.Tensor, out: torch.Tensor | None = None
) -> torch.Tensor:
    r"""All-pairs f32 Tanimoto of 0/1 int8 rows (the leader election's
    sims), written into ``out`` when given."""
    m = cent.shape[0]
    inter = _int8_gram(_pad_int8(cent, 17), cent, m).to(torch.float32)
    union = (pop[:, None] + pop[None, :]).to(torch.float32) - inter
    return torch.div(inter, union.clamp_min(1.0), out=out)


def elect_leaders_plain(
    rejected: torch.Tensor,  # (M,) bool
    force_lead: torch.Tensor,  # (M,) bool
    row_group: torch.Tensor,  # (M,) int32
    threshold: torch.Tensor,  # () f32
    sims: torch.Tensor | None = None,  # (M, M) f32
    row_pk: torch.Tensor | None = None,  # (M, F8) uint8, where sims is None
    row_pop: torch.Tensor | None = None,  # (M,) int32, where sims is None
    plan: tuple[torch.Tensor, ...] | None = None,  # unused here
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    r"""(leads, lead_of, best_lead_sim) of the module's contract with torch
    ops on (M, M) planes, ``lead_of`` and ``best_lead_sim`` on every row."""
    m = rejected.shape[0]
    row_idx = torch.arange(m, dtype=torch.int32, device=rejected.device)
    if sims is not None:
        # Step-constant sims: every use below is gated on both endpoints
        # being rejected, where masked and unmasked agree
        rsims = sims
    else:
        row_cent = unpack_fingerprints_device(row_pk).to(torch.int8)
        rcent = torch.where(rejected[:, None], row_cent, 0)
        rpop = torch.where(rejected, row_pop, 0)
        rsims = tanimoto_gram(rcent, rpop)
    same_group = row_group[:, None] == row_group[None, :]
    lower = row_idx[None, :] < row_idx[:, None]  # [j, i]: i < j
    sim_to_lower = torch.where(lower & rejected[None, :] & same_group, rsims, _NEG)
    del same_group, lower
    # Rows whose join failed last round self-promote
    leads = rejected & (force_lead | ~torch.any(sim_to_lower >= threshold, dim=1))
    sim_to_leader = torch.where(leads[None, :], sim_to_lower, _NEG)
    del sim_to_lower
    lead_of = torch.argmax(sim_to_leader, dim=1).to(torch.int32)
    best_lead_sim = sim_to_leader.amax(dim=1)
    return leads, lead_of, best_lead_sim


def _launch(rejected, force_lead, row_group, threshold, sims=None, row_pk=None,
            row_pop=None, plan=None):
    global launches
    if rejected.dim() != 1:
        raise ValueError(f"leader-election kernel: rejected must be 1-d, got {rejected.dim()}-d")
    m = rejected.shape[0]
    if sims is not None:
        raise ValueError("leader-election kernel: it takes the packed rows row_pk and row_pop, not sims")
    if row_pk is None or row_pop is None or row_pk.dim() != 2:
        raise ValueError("leader-election kernel: it needs row_pk (M, F8) and row_pop")
    if plan is None or len(plan) not in (2, 3):
        raise ValueError("leader-election kernel: it needs the step's sort plan (order, skey[, sel])")
    order, skey = plan[:2]
    sel = plan[2] if len(plan) == 3 else None
    lp = order.shape[0] if order.dim() == 1 else -1
    if sel is None and lp != m:
        raise ValueError(f"leader-election kernel: a plan of {lp} rows for {m} rows needs sel")
    f8 = row_pk.shape[1]
    dev = kernel.check(
        {
            "rejected": (rejected, torch.bool, (m,)),
            "force_lead": (force_lead, torch.bool, (m,)),
            "row_group": (row_group, torch.int32, (m,)),
            "threshold": (threshold, torch.float32, ()),
            "row_pk": (row_pk, torch.uint8, (m, f8)),
            "row_pop": (row_pop, torch.int32, (m,)),
            "order": (order, torch.int64, (lp,)),
            "skey": (skey, torch.int32, (lp,)),
            "sel": (sel, torch.int64, (m,)),
        },
    )
    if sel is not None and lp < m:
        raise ValueError(f"leader-election kernel: sel selects {m} rows of a plan of {lp}")
    leads = torch.empty((m,), dtype=torch.bool, device=dev)
    lead_of = torch.empty((m,), dtype=torch.int32, device=dev)
    best = torch.empty((m,), dtype=torch.float32, device=dev)
    if m == 0:  # no row: no launch
        return leads, lead_of, best
    scratch = torch.empty(
        (kernel.lib().bb_leader_election_scratch(m, 0 if sel is None else lp),),
        dtype=torch.uint8, device=dev,
    )
    kernel.launch(
        "bb_leader_election", dev, rejected, force_lead, threshold, row_pk, row_pop,
        order, skey, sel, leads, lead_of, best, scratch, m, f8, lp,
    )
    launches += 1
    return leads, lead_of, best


def elect_leaders(
    rejected: torch.Tensor,  # (M,) bool
    force_lead: torch.Tensor,  # (M,) bool
    row_group: torch.Tensor,  # (M,) int32
    threshold: torch.Tensor,  # () f32
    sims: torch.Tensor | None = None,  # (M, M) f32
    row_pk: torch.Tensor | None = None,  # (M, F8) uint8, where sims is None
    row_pop: torch.Tensor | None = None,  # (M,) int32, where sims is None
    plan: tuple[torch.Tensor, ...] | None = None,  # (order int64, skey int32[, sel int64])
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    r"""(leads (M,) bool, lead_of (M,) int32, best_lead_sim (M,) f32) of
    the module's contract: ``lead_of`` and ``best_lead_sim`` hold on the
    rows with ``rejected & ~leads``; on the card every other row gets 0
    and ``_NEG``, and the call takes ``row_pk``, ``row_pop`` and ``plan``
    (the module's text says what the plan is).

    Replaces ``bblean_tpu/engine/batch.py:504-540``.  On the card one call
    of ``bb_leader_election`` (``csrc/leader_election.cu``, three launches);
    on the CPU :func:`elect_leaders_plain`.
    """
    args = (rejected, force_lead, row_group, threshold, sims, row_pk, row_pop, plan)
    if rejected.device.type == "cpu":
        return elect_leaders_plain(*args)
    return _launch(*args)
