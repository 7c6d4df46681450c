r"""Seeded fingerprint libraries, made on the device.

The distribution of upstream bblean's ``make_fake_fingerprints``: each row's
popcount is drawn from a normal distribution truncated to
``[popcount_min, popcount_max]`` and rounded half to even, and that many
bits are placed uniformly at random among the row's ``n_features``.  The
draws come from one ``torch.Generator`` on the device, in chunks of rows,
so one seed gives one library on one kind of device.  It is not numpy's
bit stream and does not try to be.  Rows are packed big-endian, as
``np.packbits`` packs them.
"""

from __future__ import annotations

import torch

__all__ = ["make_library", "pack_bits", "unpack_bits"]

_BIT_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    r"""(R, F) 0/1 uint8 -> (R, F // 8) uint8, big-endian within a byte."""
    rows, n_features = bits.shape
    w = torch.tensor(_BIT_WEIGHTS, dtype=torch.uint8, device=bits.device)
    return (bits.view(rows, n_features // 8, 8) * w).sum(-1, dtype=torch.uint8)


def unpack_bits(packed: torch.Tensor) -> torch.Tensor:
    r"""(R, F8) uint8 -> (R, 8 * F8) 0/1 uint8, big-endian within a byte."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    return ((packed[:, :, None] >> shifts) & 1).reshape(packed.shape[0], 8 * packed.shape[1])


def _popcounts(
    n: int, loc: float, scale: float, lo: int, hi: int, gen: torch.Generator
) -> torch.Tensor:
    r"""(n,) int64 popcounts: a normal truncated to [lo, hi] by redrawing
    what falls outside, rounded half to even."""
    x = torch.randn(n, generator=gen, device=gen.device, dtype=torch.float64) * scale + loc
    while True:
        out = (x < lo) | (x > hi)
        k = int(out.sum())
        if k == 0:
            return torch.round(x).long()
        x[out] = torch.randn(k, generator=gen, device=gen.device, dtype=torch.float64) * scale + loc


def make_library(
    n_rows: int,
    n_features: int,
    seed: int,
    *,
    popcount_loc: float,
    popcount_scale: float,
    popcount_min: int,
    popcount_max: int,
    chunk_rows: int,
    device: str | torch.device,
) -> torch.Tensor:
    r"""(n_rows, n_features // 8) uint8 packed rows on ``device``.

    Each chunk sorts one random int32 key per bit of its rows; a row's
    bits are the positions of its ``popcount`` smallest keys, so every
    placement of that many bits is equally likely.
    """
    if n_features % 8 or not 1 <= popcount_min <= popcount_max <= n_features:
        raise ValueError("popcounts must lie in [1, n_features], n_features a multiple of 8")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    counts = _popcounts(n_rows, popcount_loc, popcount_scale, popcount_min, popcount_max, gen)
    out = torch.empty((n_rows, n_features // 8), dtype=torch.uint8, device=device)
    cols = torch.arange(n_features, device=device)
    for start in range(0, n_rows, chunk_rows):
        stop = min(start + chunk_rows, n_rows)
        keys = torch.randint(
            0, 1 << 31, (stop - start, n_features), generator=gen,
            device=device, dtype=torch.int32,
        )
        rank_order = keys.sort(dim=1).indices
        del keys
        on = (cols < counts[start:stop, None]).to(torch.uint8)
        bits = torch.zeros_like(on).scatter_(1, rank_order, on)
        del rank_order, on
        out[start:stop] = pack_bits(bits)
    return out
