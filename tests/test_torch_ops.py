r"""PyTorch port's device ops vs their JAX twins (``bblean_tpu/ops``).

Same numpy inputs through both; integer and boolean results must be equal,
and f32 results bit-equal, unless a test states otherwise.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bblean_tpu.fingerprints import make_fake_fingerprints
from bblean_tpu.ops import isim as jisim
from bblean_tpu.ops import merges as jmerges
from bblean_tpu.ops import packing as jpacking
from bblean_tpu_torch.ops import isim as tisim
from bblean_tpu_torch.ops import merges as tmerges
from bblean_tpu_torch.ops import packing as tpacking

torch.set_num_threads(2)

SEED = 17408390758220920002


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("n_features", [2048, 100, 264])
def test_pack_unpack_match_jax(n_features) -> None:
    bits = make_fake_fingerprints(32, n_features=2048, seed=SEED, pack=False)
    bits = bits[:, :n_features]
    packed = np.packbits(bits, axis=-1)
    got_unpack = tpacking.unpack_fingerprints_device(_t(packed), n_features)
    ref_unpack = jpacking.unpack_fingerprints_device(packed, n_features)
    np.testing.assert_array_equal(got_unpack.numpy(), np.asarray(ref_unpack))
    np.testing.assert_array_equal(got_unpack.numpy(), bits)
    got_pack = tpacking.pack_fingerprints_device(_t(bits))
    np.testing.assert_array_equal(
        got_pack.numpy(), np.asarray(jpacking.pack_fingerprints_device(bits))
    )
    assert got_pack.dtype == torch.uint8


def _prefix_sums(n_rows, ns, n_features=2048):
    fps = make_fake_fingerprints(n_rows, n_features=n_features, seed=SEED, pack=False)
    sums = np.stack([fps[:n].sum(0) for n in ns]).astype(np.int32)
    return sums, np.asarray(ns, dtype=np.int32)


@pytest.mark.parametrize(
    "n_rows,ns",
    [
        (100, [2, 5, 10, 50, 100]),  # test_ops.test_isim_from_sums_batched
        (30, [1, 3, 30]),  # test_ops.test_majority_centroid_batched
        (60, [2, 10, 60]),  # test_ops.test_radius_compl_batched
    ],
)
def test_isim_centroid_radius_match_jax(n_rows, ns) -> None:
    sums, ns = _prefix_sums(n_rows, ns)
    for name in (
        "isim_from_sums", "majority_centroid_from_sums",
        "isim_radius_compl_from_sums",
    ):
        got = getattr(tisim, name)(_t(sums), _t(ns)).numpy()
        ref = np.asarray(getattr(jisim, name)(jnp.asarray(sums), jnp.asarray(ns)))
        assert got.dtype == ref.dtype, name
        np.testing.assert_array_equal(got, ref, err_msg=name)


def test_isim_edges_match_jax() -> None:
    r"""All-zero sums give 1.0 and n < 2 gives NaN, as in JAX."""
    sums = np.zeros((2, 64), dtype=np.int32)
    ns = np.array([5, 1], dtype=np.int32)
    got = tisim.isim_from_sums(_t(sums), _t(ns)).numpy()
    ref = np.asarray(jisim.isim_from_sums(sums, ns))
    np.testing.assert_array_equal(got, ref)
    assert got[0] == 1.0 and np.isnan(got[1])


def test_isim_exact_sums_past_f32_range() -> None:
    r"""Where Ksq and n*K exceed 2^24 the port's iSIM is still the exact
    quotient rounded once to f32: the float64 host formula on exact
    integer sums, cast to f32 (one ulp of f32 is far above float64's
    rounding error here)."""
    rng = np.random.default_rng(0)
    ls = (rng.random((4, 2048)) * 5000).astype(np.int32)
    ns = np.array([5000, 6000, 7000, 8000], dtype=np.int32)
    got = tisim.isim_from_sums(_t(ls), _t(ns)).numpy()
    k = ls.astype(np.int64).sum(1)
    ksq = (ls.astype(np.int64) ** 2).sum(1)
    a = (ksq - k) // 2
    assert (ksq > 2**24).all() and (ns * k > 2**24).all()
    expect = (a / (a + ns.astype(np.int64) * k - ksq)).astype(np.float32)
    np.testing.assert_array_equal(got, expect)


@pytest.mark.parametrize("criterion", tmerges.DEVICE_MERGES)
@pytest.mark.parametrize("threshold", [0.1, 0.3, 0.65])
def test_merge_accept_batch_matches_jax(criterion, threshold) -> None:
    r"""The grid of ``tests/test_ops.py::test_merge_accept_batch_matches_host``
    plus a dense sweep of candidate sizes, through both ports."""
    fps = make_fake_fingerprints(512, n_features=512, seed=3, pack=False).astype(
        np.int64
    )
    cases = [(1, 1), (1, 3), (4, 1), (8, 1), (10, 5)] + [
        (k, m) for k in (1, 2, 3, 6, 20) for m in (1, 2, 7)
    ]
    new_ls, new_n, old_ls, old_n, nom_n = [], [], [], [], []
    cursor = 0
    for k, m in cases:
        old = fps[cursor : cursor + k]
        nom = fps[cursor + k : cursor + k + m]
        cursor += k + m
        new_ls.append(old.sum(0) + nom.sum(0))
        new_n.append(k + m)
        old_ls.append(old.sum(0))
        old_n.append(k)
        nom_n.append(m)
    args = (
        np.stack(new_ls).astype(np.int32), np.array(new_n, np.int32),
        np.stack(old_ls).astype(np.int32), np.array(old_n, np.int32),
        np.array(nom_n, np.int32),
    )
    ref = np.asarray(
        jmerges.merge_accept_batch(criterion, threshold, *args, tolerance=0.05)
    )
    got = tmerges.merge_accept_batch(
        criterion, threshold, *map(_t, args), tolerance=0.05
    ).numpy()
    np.testing.assert_array_equal(got, ref)


def test_adaptive_tol_within_one_ulp() -> None:
    r"""``_adaptive_tol`` goes through ``exp``, whose f32 result may differ
    by one ulp between XLA and PyTorch.  ``exp`` of a value in (-1.2, 0]
    lies in (0.3, 1], where one ulp is at most 2^-24 absolute; the
    difference then passes through ``- offset`` and ``* tolerance`` (0.05),
    each rounding once, so the bound is ``2 * 0.05 * 2^-23``, absolute.
    The tolerance criteria compare ``old_c - tol``, so a decision can
    differ only within that margin of the comparison."""
    old_n = np.arange(0, 1200, 7, dtype=np.int32)
    ref = np.asarray(jmerges._adaptive_tol(jnp.float32(0.05), jnp.asarray(old_n)))
    got = tmerges._adaptive_tol(
        torch.tensor(0.05, dtype=torch.float32), _t(old_n)
    ).numpy()
    assert got.dtype == ref.dtype == np.float32
    x = (-1e-3 * old_n.astype(np.float32)).astype(np.float32)
    np.testing.assert_array_max_ulp(
        torch.exp(_t(x)).numpy(), np.asarray(jnp.exp(jnp.asarray(x))), maxulp=1
    )
    np.testing.assert_allclose(got, ref, rtol=0, atol=2 * 0.05 * 2**-23)
    assert (got[old_n >= 1000] == 0).all() and (ref[old_n >= 1000] == 0).all()
