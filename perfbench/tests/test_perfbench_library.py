r"""The seeded library generator (``perfbench/library.py``)."""

from __future__ import annotations

import numpy as np
import pytest
import scipy.stats
import torch

from perfbench.library import make_library, pack_bits, unpack_bits

DIST = dict(popcount_loc=750, popcount_scale=400, popcount_min=1, popcount_max=2047)


def _lib(n: int, seed: int, device: str = "cpu", chunk_rows: int = 8192) -> torch.Tensor:
    return make_library(n, 2048, seed, chunk_rows=chunk_rows, device=device, **DIST)


def _check_distribution(lib: torch.Tensor) -> None:
    bits = unpack_bits(lib).to(torch.int64)
    pop = bits.sum(1).double().cpu().numpy()
    ref = scipy.stats.truncnorm((1 - 750) / 400, (2047 - 750) / 400, loc=750, scale=400)
    n = len(pop)
    # Means and deviations within five standard errors of the truncated normal's
    assert abs(pop.mean() - ref.mean()) < 5 * ref.std() / np.sqrt(n)
    assert abs(pop.std() - ref.std()) < 5 * ref.std() / np.sqrt(2 * n)
    assert pop.min() >= 1 and pop.max() <= 2047
    # Bits placed uniformly: every column's share of ones is the mean share
    share = bits.double().mean(0).cpu().numpy()
    p = pop.mean() / 2048
    assert np.abs(share - p).max() < 6 * np.sqrt(p * (1 - p) / n)
    # A Kolmogorov-Smirnov test against the rounded truncated normal
    assert scipy.stats.kstest(pop + np.random.default_rng(0).uniform(-0.5, 0.5, n), ref.cdf).pvalue > 1e-3


def test_popcounts_follow_the_upstream_distribution():
    _check_distribution(_lib(60_000, 2**31 + 77))


def test_same_seed_same_library_other_seed_other_library():
    a, b = _lib(5000, 123456789012, chunk_rows=1024), _lib(5000, 123456789012, chunk_rows=1024)
    assert torch.equal(a, b)
    assert not torch.equal(a, _lib(5000, 123456789013, chunk_rows=1024))


def test_chunking_changes_no_row_count_or_shape():
    lib = _lib(3000, 5, chunk_rows=700)
    assert lib.shape == (3000, 256) and lib.dtype == torch.uint8


def test_pack_matches_numpy_packbits():
    bits = torch.randint(0, 2, (17, 2048), dtype=torch.uint8)
    packed = pack_bits(bits)
    assert np.array_equal(packed.numpy(), np.packbits(bits.numpy(), axis=1))
    assert torch.equal(unpack_bits(packed), bits)


def test_bad_popcount_range_is_refused():
    with pytest.raises(ValueError):
        make_library(10, 2048, 1, chunk_rows=10, device="cpu", **{**DIST, "popcount_max": 4096})


@pytest.mark.cuda
def test_library_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    a, b = _lib(60_000, 2**31 + 5, "cuda"), _lib(60_000, 2**31 + 5, "cuda")
    assert torch.equal(a, b)
    _check_distribution(a)
