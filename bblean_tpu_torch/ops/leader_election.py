r"""The insert round's leader election, with a CUDA kernel on the card and
the plain PyTorch version.

Counterpart of ``bblean_tpu/engine/batch.py:504-540`` (step 4 of JAX's
``_insert_round``), which XLA fuses inside its jitted step: among the
round's rejected rows, each routed group elects as leaders the rows that no
lower rejected row of the group is similar to (or that were struck twice),
and every row finds its most similar leader below it.

Contract.  A pair (j, i) counts where ``i < j``, ``rejected[i]`` and
``row_group[i] == row_group[j]``; its sim is ``sims[j, i]`` (the step's
all-pairs row Tanimoto, wide rounds) or, where ``sims`` is None (narrow
rounds), the f32 Tanimoto of the packed rows ``row_pk`` with popcounts
``row_pop``, row j's bits counting as zero unless it is rejected (the
Gram of the rejected rows, computed in the round).  Then

- ``leads = rejected & (force_lead | ~any(sim >= threshold))`` over the
  counted pairs of each row (and its ``_NEG`` entries, as the plain
  version's (M, M) row has them);
- ``best_lead_sim`` the largest sim over the counted pairs whose ``i``
  leads, ``_NEG = -2.0`` where there is none;
- ``lead_of`` the first such ``i`` with that sim, 0 where there is none
  (what ``torch.argmax`` gives over a row of ``_NEG``).

Sims are Tanimoto values (finite, at least 0).  The kernel's outputs equal
the plain version's bit for bit.

Dispatch: tensors on the CPU go to :func:`elect_leaders_plain` (the torch
chain of (M, M) planes the engine ran before, and the in-round int8 Gram);
tensors on a CUDA device go to the hand-written kernel of
``csrc/leader_election.cu`` and anything it does not take raises.  There is
no fallback from the kernel to the plain version.  ``launches`` counts the
wrapper's calls that launched the kernel (each call launches its two
phases: the leaders, then each row's best leader).  The kernel visits only
the pairs of one group, through the rows sorted by group: ``plan`` (the
step's sort plan, ``(order, skey)``, in which every rejected row sits in
its group's segment in row order) or, without one, a stable sort of
``row_group`` made by the wrapper.
"""

from __future__ import annotations

import ctypes

import torch

from bblean_tpu_torch.ops.packing import unpack_fingerprints_device
from bblean_tpu_torch.ops.tanimoto import _int8_gram, _pad_int8

__all__ = [
    "elect_leaders",
    "elect_leaders_plain",
    "tanimoto_gram",
    "launches",
]

_NEG = -2.0  # below any similarity
_SOURCE = "leader_election.cu"

# Calls of elect_leaders that launched the kernel
launches = 0

_kernel_lib: ctypes.CDLL | None = None


def _lib() -> ctypes.CDLL:
    global _kernel_lib
    if _kernel_lib is None:
        from bblean_tpu_torch._build import load_kernel_library

        lib = load_kernel_library(_SOURCE)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.bb_leader_election.argtypes = [p] * 12 + [i] * 2 + [p]
        lib.bb_leader_election.restype = i
        _kernel_lib = lib
    return _kernel_lib


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
    plan: tuple[torch.Tensor, torch.Tensor] | None = None,  # unused here
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    r"""(leads, lead_of, best_lead_sim) of the module's contract with torch
    ops on (M, M) planes."""
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


def _check(named: dict) -> torch.device:
    r"""Raise unless every given tensor is on one CUDA device, contiguous,
    of its dtype and shape (``named``: name -> (tensor or None, dtype,
    shape)); returns the device."""
    dev = named["rejected"][0].device
    for name, (t, dtype, shape) in named.items():
        if t is None:
            continue
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(
                f"leader-election kernel needs every tensor on one CUDA device; "
                f"{name} is on {t.device}, rejected on {dev}"
            )
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"leader-election kernel: {name} must be {dtype} of shape {shape}, "
                f"got {t.dtype} of shape {tuple(t.shape)}"
            )
        if not t.is_contiguous():
            raise ValueError(f"leader-election kernel: {name} must be contiguous")
    return dev


def _launch(rejected, force_lead, row_group, threshold, sims=None, row_pk=None,
            row_pop=None, plan=None):
    global launches
    if rejected.dim() != 1:
        raise ValueError(f"leader-election kernel: rejected must be 1-d, got {rejected.dim()}-d")
    m = rejected.shape[0]
    if sims is None and (row_pk is None or row_pop is None or row_pk.dim() != 2):
        raise ValueError("leader-election kernel: without sims it needs row_pk (M, F8) and row_pop")
    f8 = 0 if sims is not None else row_pk.shape[1]
    order, skey = plan if plan is not None else (None, None)
    dev = _check(
        {
            "rejected": (rejected, torch.bool, (m,)),
            "force_lead": (force_lead, torch.bool, (m,)),
            "row_group": (row_group, torch.int32, (m,)),
            "threshold": (threshold, torch.float32, ()),
            "sims": (sims, torch.float32, (m, m)),
            "row_pk": (None if sims is not None else row_pk, torch.uint8, (m, f8)),
            "row_pop": (None if sims is not None else row_pop, torch.int32, (m,)),
            "order": (order, torch.int64, (m,)),
            "skey": (skey, torch.int32, (m,)),
        },
    )
    leads = torch.empty((m,), dtype=torch.bool, device=dev)
    lead_of = torch.empty((m,), dtype=torch.int32, device=dev)
    best = torch.empty((m,), dtype=torch.float32, device=dev)
    if m == 0:  # no row: no launch
        return leads, lead_of, best
    lib = _lib()
    with torch.cuda.device(dev):
        if plan is None:
            skey, order = torch.sort(row_group, stable=True)
        stream = torch.cuda.current_stream(dev).cuda_stream
        ptr = [None if t is None else t.data_ptr() for t in (sims, row_pk, row_pop)]
        if sims is not None:
            ptr[1] = ptr[2] = None
        err = lib.bb_leader_election(
            rejected.data_ptr(), force_lead.data_ptr(), row_group.data_ptr(),
            threshold.data_ptr(), *ptr, order.data_ptr(), skey.data_ptr(),
            leads.data_ptr(), lead_of.data_ptr(), best.data_ptr(), m, f8, stream,
        )
    if err != 0:
        raise RuntimeError(f"leader-election kernel launch failed: CUDA error {err}")
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
    plan: tuple[torch.Tensor, torch.Tensor] | None = None,  # (order int64, skey int32)
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    r"""(leads (M,) bool, lead_of (M,) int32, best_lead_sim (M,) f32) of
    the module's contract.

    Replaces ``bblean_tpu/engine/batch.py:504-540``.  On the card one call
    of ``bb_leader_election`` (``csrc/leader_election.cu``); on the CPU
    :func:`elect_leaders_plain`.
    """
    args = (rejected, force_lead, row_group, threshold, sims, row_pk, row_pop, plan)
    if rejected.device.type == "cpu":
        return elect_leaders_plain(*args)
    return _launch(*args)
