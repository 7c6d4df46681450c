r"""``BatchState`` <-> numpy, under the JAX engine's field names.

Carries an engine state across between the JAX engine
(``bblean_tpu.engine.batch.BatchState``) and this port: a JAX state goes
through ``{field: np.asarray(value)}`` into :func:`state_from_numpy`, and
:func:`state_to_numpy` gives the same dict back.  The sharded JAX engine
stacks its shards' states along a leading device axis;
:func:`states_from_stacked` cuts such a dict into this port's list of
shards and :func:`states_to_stacked` stacks a list back.
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch

from bblean_tpu_torch._device import DeviceLike, require_device
from bblean_tpu_torch.engine.batch import BatchState

__all__ = [
    "state_from_numpy",
    "state_to_numpy",
    "states_from_stacked",
    "states_to_stacked",
]

_DTYPES = {
    "t_pk": torch.uint8,
    "g_cent": torch.int8,
}


def state_from_numpy(
    arrays: dict[str, np.ndarray], device: DeviceLike = "cuda"
) -> BatchState:
    r"""Build a :class:`BatchState` on ``device`` from numpy arrays keyed by
    field name (uint8 tiles, int8 routing centroids, int32 elsewhere).

    ``device`` defaults to the CUDA device and raises when there is none
    (ask for ``"cpu"`` explicitly)."""
    missing = set(BatchState._fields) - set(arrays)
    if missing:
        raise KeyError(f"state arrays lack fields {sorted(missing)}")
    device = require_device(device)
    return BatchState(
        **{
            f: torch.tensor(
                np.asarray(arrays[f]),
                dtype=_DTYPES.get(f, torch.int32),
                device=device,
            )
            for f in BatchState._fields
        }
    )


def state_to_numpy(state: BatchState) -> dict[str, np.ndarray]:
    r"""Copy every table of ``state`` to a numpy array, keyed by field."""
    return {f: getattr(state, f).cpu().numpy() for f in BatchState._fields}


def states_from_stacked(
    arrays: dict[str, np.ndarray],
    devices: tp.Sequence[DeviceLike] | None = None,
) -> list[BatchState]:
    r"""Cut a stacked state (every field with a leading shard axis) into one
    :class:`BatchState` per shard, shard ``i`` on ``devices[i]`` (default:
    all on the CUDA device, which raises when there is none)."""
    n = len(np.asarray(arrays["num"]))
    if devices is None:
        devices = ["cuda"] * n
    if len(devices) != n:
        raise ValueError(f"{n} stacked shards for {len(devices)} devices")
    return [
        state_from_numpy({f: np.asarray(v)[i] for f, v in arrays.items()}, dev)
        for i, dev in enumerate(devices)
    ]


def states_to_stacked(states: tp.Sequence[BatchState]) -> dict[str, np.ndarray]:
    r"""Stack the shards' tables (equal capacities) along a leading axis."""
    parts = [state_to_numpy(s) for s in states]
    return {f: np.stack([p[f] for p in parts]) for f in BatchState._fields}
