r"""The port on a CUDA card: the tile-search kernel against its plain version,
and CPU and CUDA fits giving the same labels.

Marked ``cuda``: each test skips unless a CUDA device is available.  This
file imports no JAX, so that it also runs where JAX is not installed; on
the card, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from bblean_tpu.fingerprints import make_fake_fingerprints
from bblean_tpu_torch import BatchTree
from bblean_tpu_torch.ops import tile_search as ts

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _case(rng, m, g, fc, f8, spread, empty=False):
    t_pk = rng.integers(0, 256, (g, fc, f8), dtype=np.uint8)
    occ = rng.random((g, fc)) < 0.7
    if empty:
        occ[:] = False
    occ[g - 1] = False  # the engine's guard tile
    t_slot = np.where(occ, rng.integers(0, 1 << 20, (g, fc)), -1).astype(np.int32)
    t_pk[~occ] = 0
    t_pops = np.unpackbits(t_pk, axis=-1).sum(-1).astype(np.int32)
    row_pk = rng.integers(0, 256, (m, f8), dtype=np.uint8)
    row_pop = np.unpackbits(row_pk, axis=1).sum(1).astype(np.int32)
    row_group = rng.integers(0, spread, m).astype(np.int32)
    pending = rng.random(m) < 0.8
    return row_pk, row_pop, row_group, t_pk, t_pops, t_slot, pending


@pytest.mark.parametrize(
    "m,g,fc,f8,spread,empty",
    [
        (2048, 64, 256, 256, 3, False),
        (2048, 64, 512, 256, 63, False),
        (1, 4, 8, 256, 1, False),
        (700, 16, 64, 33, 15, False),  # byte tail: 264-bit rows
        (300, 8, 40, 13, 7, False),
        (512, 8, 256, 256, 7, True),
    ],
)
def test_kernel_matches_plain(cuda, m, g, fc, f8, spread, empty) -> None:
    rng = np.random.default_rng(m + fc + f8)
    args = [torch.from_numpy(a).to(cuda) for a in _case(rng, m, g, fc, f8, spread, empty)]
    row_pk, row_pop, row_group, t_pk, t_pops, t_slot, pending = args
    before = ts.launches
    got = ts.tile_search_sorted(*args, guard_group=g - 1)
    assert ts.launches == before + 1
    ref = ts.search_tiles_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got[0], ref[0])
    cand = ref[0] > -1.5
    assert torch.equal(got[1][cand], ref[1][cand])
    assert not empty or not bool(cand.any())


def test_kernel_wrapper_rejects_bad_inputs(cuda) -> None:
    rng = np.random.default_rng(0)
    args = [torch.from_numpy(a).to(cuda) for a in _case(rng, 64, 4, 32, 256, 3)]
    order, skey = ts.sorted_search_plan(args[2])
    srows, spops = args[0][order], args[1][order]
    rest = (args[3], args[4], args[5], args[6])
    with pytest.raises(ValueError, match="must be"):
        ts.tile_search_planned(srows, spops.long(), skey, order, *rest)
    with pytest.raises(ValueError, match="contiguous"):
        ts.tile_search_planned(srows, spops, skey, order, args[3].transpose(1, 2), *rest[1:])
    with pytest.raises(ValueError, match="CUDA device"):
        ts.tile_search_planned(srows, spops.cpu(), skey, order, *rest)


def test_cpu_and_cuda_fits_give_equal_labels(cuda) -> None:
    fps = make_fake_fingerprints(3000, seed=12620509540149709235)
    labels = []
    for device in ("cpu", cuda):
        tree = BatchTree(2048, threshold=0.3, batch_size=128, route_block=64,
                         initial_capacity=2048, device=device)
        tree.fit_packed(fps, range(len(fps)))
        labels.append(tree.assignments())
    np.testing.assert_array_equal(labels[0], labels[1])
