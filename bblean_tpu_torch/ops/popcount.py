r"""Popcount over packed fingerprint rows.

Port of ``bblean_tpu/ops/popcount.py``.  PyTorch has no population-count
op, so bytes are counted with shifts and masks (SWAR); the tile search's
plain version counts with the same function.

A tensor is counted on its own device; a numpy array goes to ``device``
(default ``"cuda"``).
"""

from __future__ import annotations

import typing as tp

import torch

from bblean_tpu_torch._device import DeviceLike, as_tensor_on

__all__ = ["popcount_device", "popcount_rows"]


def _popcount_u8(x: torch.Tensor) -> torch.Tensor:
    r"""Per-byte popcount of a uint8 tensor (SWAR, stays uint8)."""
    x = x - ((x >> 1) & 0x55)
    x = (x & 0x33) + ((x >> 2) & 0x33)
    return (x + (x >> 4)) & 0x0F


def popcount_device(packed: tp.Any, device: DeviceLike | None = None) -> torch.Tensor:
    r"""Per-row popcount of a packed (..., B) uint8 array -> (...,) int32."""
    packed = as_tensor_on(packed, device)
    if packed.dtype != torch.uint8:
        raise ValueError(f"packed rows must be uint8, got {packed.dtype}")
    return _popcount_u8(packed).sum(dim=-1, dtype=torch.int32)


def popcount_rows(unpacked: tp.Any, device: DeviceLike | None = None) -> torch.Tensor:
    r"""Per-row popcount of an unpacked (..., F) 0/1 array -> (...,) int32."""
    return as_tensor_on(unpacked, device).sum(dim=-1, dtype=torch.int32)
