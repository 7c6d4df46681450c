r"""Fingerprint bit packing / unpacking on torch tensors.

Port of ``bblean_tpu/ops/packing.py``: big-endian bit order within each
byte (the order of ``np.packbits`` / ``np.unpackbits``), with trimming of
the trailing pad bits to ``n_features``.
"""

from __future__ import annotations

import torch

__all__ = ["unpack_fingerprints_device", "pack_fingerprints_device"]

_BIT_SHIFTS = (7, 6, 5, 4, 3, 2, 1, 0)


def _shifts(device: torch.device) -> torch.Tensor:
    r""":data:`_BIT_SHIFTS` made on ``device`` (no copy from the host, so
    that a CUDA graph can capture it)."""
    return (7 - torch.arange(8, device=device)).to(torch.uint8)


def unpack_fingerprints_device(
    packed: torch.Tensor, n_features: int | None = None
) -> torch.Tensor:
    r"""Unpack a (..., B) uint8 tensor to (..., B*8) 0/1 uint8 bits.

    ``n_features`` trims the trailing pad bits.
    """
    packed = packed.to(torch.uint8)
    bits = (packed[..., :, None] >> _shifts(packed.device)) & 1
    out = bits.reshape(*packed.shape[:-1], packed.shape[-1] * 8)
    if n_features is not None:
        out = out[..., :n_features]
    return out


def pack_fingerprints_device(bits: torch.Tensor) -> torch.Tensor:
    r"""Pack a (..., F) 0/1 tensor into (..., ceil(F/8)) uint8 bytes."""
    f = bits.shape[-1]
    pad = (-f) % 8
    bits = bits.to(torch.uint8)
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    grouped = bits.reshape(*bits.shape[:-1], -1, 8)
    packed = torch.zeros(grouped.shape[:-1], dtype=torch.uint8, device=bits.device)
    for j, shift in enumerate(_BIT_SHIFTS):
        packed |= grouped[..., j] << shift
    return packed
