r"""Table primitives of the port: the torch counterparts of JAX's segment
ops and drop-mode scatters, which the batch engine and the kernels' plain
versions share.

torch has no drop mode for out-of-bounds scatters, so the masked rows of
:func:`_drop_set_` and :func:`_drop_add_` go to the table's top slot, which
the batch engine keeps free as a guard, and write back its own value or add
zero there.
"""

from __future__ import annotations

import torch

_BIG = 1 << 30  # sort key of masked rows
_I32 = torch.int32


def _isum(x: torch.Tensor, dim: int | None = None) -> torch.Tensor:
    r"""int32 sum (torch sums integers to int64 by default)."""
    if dim is None:
        return x.sum(dtype=_I32)
    return x.sum(dim=dim, dtype=_I32)


def _icumsum(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    return torch.cumsum(x, dim=dim, dtype=_I32)


def _segment_sum(vals: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    out = torch.zeros((n, *vals.shape[1:]), dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, seg.long(), vals)


def _segment_min(vals: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    r"""``jax.ops.segment_min``: empty segments hold int32 max."""
    out = torch.full((n,), torch.iinfo(_I32).max, dtype=_I32, device=vals.device)
    return out.scatter_reduce_(0, seg.long(), vals.to(_I32), "amin", include_self=False)


def _segment_max(vals: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    r"""``jax.ops.segment_max``: empty segments hold int32 min."""
    out = torch.full((n,), torch.iinfo(_I32).min, dtype=_I32, device=vals.device)
    return out.scatter_reduce_(0, seg.long(), vals.to(_I32), "amax", include_self=False)


def _bcast(mask: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    return mask.view(mask.shape + (1,) * (val.dim() - mask.dim()))


def _drop_set_(
    tab: torch.Tensor, idx: torch.Tensor, val: torch.Tensor, keep: torch.Tensor
) -> None:
    r"""In place ``tab[idx] = val`` where ``keep`` and ``idx`` is in range
    (JAX ``.at[idx].set(val, mode="drop")`` with the masked rows' index
    out of range).  Kept indices must be unique and must not be the guard
    (top) slot; masked rows write the guard's own value back to it."""
    cap = tab.shape[0]
    keep = keep & (idx < cap)
    guard = cap - 1
    i = torch.where(keep, idx, guard).long()
    val = val.to(tab.dtype)
    v = torch.where(_bcast(keep, val), val, tab[guard])
    tab.index_put_((i,), v)


def _drop_add_(
    tab: torch.Tensor, idx: torch.Tensor, val: torch.Tensor, keep: torch.Tensor
) -> None:
    r"""In place ``tab[idx] += val`` where ``keep`` and ``idx`` is in range;
    masked rows add zero to rows spread over the table (integer adds are
    exact in any order, and spreading avoids one hot address)."""
    cap = tab.shape[0]
    keep = keep & (idx < cap)
    spread = torch.arange(idx.shape[0], device=idx.device) % cap
    i = torch.where(keep, idx.long(), spread)
    val = val.to(tab.dtype)
    v = torch.where(_bcast(keep, val), val, torch.zeros((), dtype=tab.dtype, device=tab.device))
    tab.index_add_(0, i, v)


def _flat2(tab: torch.Tensor) -> torch.Tensor:
    r"""View (G, Fc, ...) as (G * Fc, ...) for scatters at (group, pos)."""
    return tab.view(tab.shape[0] * tab.shape[1], *tab.shape[2:])


def _group_ids_by_key(
    key: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    r"""Stable grouping of rows by an int key -> (order, group_of_sorted,
    is_group_start); equal keys form one group, ordered by row index."""
    sorted_key, order = torch.sort(key, stable=True)
    is_start = torch.ones_like(sorted_key, dtype=torch.bool)
    is_start[1:] = sorted_key[1:] != sorted_key[:-1]
    group = _icumsum(is_start) - 1
    return order, group, is_start
