r"""The port's per-row tile search vs the JAX per-row search.

``bblean_tpu_torch.ops.tile_search.tile_search_rows`` on CPU tensors (its
plain version, what the wrapper runs there) is held to the Pallas kernel
``tile_search_pallas`` in interpret mode, as ``tests/test_pallas_search.py``
runs it, and to the XLA gather ``_search_tiles``, on the same numpy-made
inputs.  Contract: sims equal bit for bit, slots equal wherever
``sim > -1.5``.  The CUDA kernel itself runs only on a card, where
``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold it to this plain
version.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bblean_tpu.engine.batch import _search_tiles
from bblean_tpu.ops.pallas_search import tile_search_pallas
from bblean_tpu_torch.ops import tile_search as ts

torch.set_num_threads(2)


def _mk(seed, m=32, g=8, fc=16, f8=32, pending_every=0, empty=False):
    r"""numpy inputs shaped like ``test_pallas_search._random_state``."""
    rng = np.random.default_rng(seed)
    t_pk = rng.integers(0, 256, (g, fc, f8), dtype=np.uint8)
    t_pops = np.unpackbits(t_pk, axis=-1).sum(-1).astype(np.int32)
    occ = rng.random((g, fc)) < 0.6
    if empty:
        occ[:] = False
    t_slot = np.where(occ, np.arange(fc, dtype=np.int32)[None, :], -1).astype(np.int32)
    row_pk = rng.integers(0, 256, (m, f8), dtype=np.uint8)
    row_pop = np.unpackbits(row_pk, axis=1).sum(1).astype(np.int32)
    row_group = rng.integers(0, g, m).astype(np.int32)
    pending = np.ones(m, bool)
    if pending_every:
        pending[::pending_every] = False
    return [row_pk, row_pop, row_group, t_pk, t_pops, t_slot, pending]


def _port(args):
    return ts.tile_search_rows(*(torch.from_numpy(a) for a in args))


def _assert_contract(ref, got) -> None:
    ref_sim, ref_slot = (np.asarray(x) for x in ref)
    got_sim, got_slot = (np.asarray(x) for x in got)
    assert got_sim.dtype == np.float32 and got_slot.dtype == np.int32
    np.testing.assert_array_equal(got_sim, ref_sim)
    has_cand = ref_sim > -1.5
    np.testing.assert_array_equal(got_slot[has_cand], ref_slot[has_cand])
    assert (got_slot >= 0).all()


@pytest.mark.parametrize(
    "seed,kw",
    [
        (0, {}),
        (1, {}),
        (2, {}),
        (3, dict(pending_every=2)),  # pending mask
        (4, dict(empty=True)),  # all-empty tiles
        (5, dict(f8=33)),  # byte tail: 264-bit rows
        (6, dict(m=24, g=3, fc=512, f8=8)),  # wide tile
    ],
    ids=["seed0", "seed1", "seed2", "pending", "empty", "f8-33", "fc-512"],
)
def test_row_search_matches_jax(seed, kw) -> None:
    args = _mk(seed, **kw)
    jargs = [jnp.asarray(a) for a in args]
    got = _port(args)
    _assert_contract(_search_tiles(*jargs), got)
    _assert_contract(tile_search_pallas(*jargs, interpret=True), got)
    if kw.get("empty"):
        assert (got[0].numpy() == -2.0).all() and (got[1].numpy() == 0).all()
    if kw.get("pending_every"):
        assert (got[0].numpy()[::2] == -2.0).all()


def test_row_search_out_of_range_group_on_masked_row() -> None:
    r"""A non-pending row may carry any group: it gets -2, as in JAX; the
    other rows are unaffected."""
    args = _mk(7, pending_every=3)
    g = args[3].shape[0]
    args[2][0] = g + 5  # masked rows (every third) with groups out of range
    args[2][3] = -4
    args[2][6] = 1 << 20
    got = _port(args)
    _assert_contract(_search_tiles(*[jnp.asarray(a) for a in args]), got)
    assert (got[0].numpy()[[0, 3, 6]] == -2.0).all()


@pytest.mark.parametrize("pending_every", [0, 3])
def test_row_search_out_of_range_group_on_pending_row(pending_every) -> None:
    r"""A pending row whose group is outside the table reads the group
    JAX's gather reads (a negative group wraps once, then the index is
    clamped): the same sims and slots as ``_search_tiles``, in both launch
    modes' plain paths."""
    args = _mk(10, pending_every=pending_every)
    g = args[3].shape[0]
    rows = [1, 2, 4, 5, 7, 8]  # pending whether or not every third is masked
    args[2][rows] = [g, g + 5, -1, -g, -g - 3, 1 << 30]
    ref = _search_tiles(*[jnp.asarray(a) for a in args])
    assert (np.asarray(ref[0])[rows] > -1.5).all()  # each row has a candidate
    _assert_contract(ref, _port(args))
    _assert_contract(ref, ts.tile_search_sorted(*(torch.from_numpy(a) for a in args)))


def test_row_search_equals_sorted_search() -> None:
    r"""The two launch modes' plain paths agree on the engine's inputs."""
    args = [torch.from_numpy(a) for a in _mk(8, m=64, pending_every=5)]
    rows = ts.tile_search_rows(*args)
    srt = ts.tile_search_sorted(*args)
    np.testing.assert_array_equal(rows[0].numpy(), srt[0].numpy())
    cand = rows[0] > -1.5
    np.testing.assert_array_equal(rows[1][cand].numpy(), srt[1][cand].numpy())


def test_row_search_wrapper_raises_off_cpu_without_the_kernel() -> None:
    r"""Tensors on a device other than the CPU go to the kernel, never to
    the plain version: here ("meta" tensors) the wrapper raises."""
    meta = [torch.from_numpy(a).to("meta") for a in _mk(9, m=8)]
    with pytest.raises(ValueError, match="one CUDA device"):
        ts.tile_search_rows(*meta)
