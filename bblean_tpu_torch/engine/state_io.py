r"""``BatchState`` <-> numpy, under the JAX engine's field names.

Carries an engine state across between the JAX engine
(``bblean_tpu.engine.batch.BatchState``) and this port: a JAX state goes
through ``{field: np.asarray(value)}`` into :func:`state_from_numpy`, and
:func:`state_to_numpy` gives the same dict back.
"""

from __future__ import annotations

import numpy as np
import torch

from bblean_tpu_torch.engine.batch import BatchState

__all__ = ["state_from_numpy", "state_to_numpy"]

_DTYPES = {
    "t_pk": torch.uint8,
    "g_cent": torch.int8,
}


def state_from_numpy(
    arrays: dict[str, np.ndarray], device: str | torch.device = "cpu"
) -> BatchState:
    r"""Build a :class:`BatchState` on ``device`` from numpy arrays keyed by
    field name (uint8 tiles, int8 routing centroids, int32 elsewhere)."""
    missing = set(BatchState._fields) - set(arrays)
    if missing:
        raise KeyError(f"state arrays lack fields {sorted(missing)}")
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
