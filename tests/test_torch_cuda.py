r"""The port on a CUDA card: the tile-search kernels (sorted and per-row
launch modes) and the sort plan's item-table kernel against their plain
versions, CPU and CUDA fits giving the
same labels, predict giving the same answer at aligned and unaligned
batch sizes, the side ops (popcount, Tanimoto, k-means, t-SNE) against the
same functions on the CPU, one command-line run on each device, and the
sharded engine's merge on shards of one card (and, where there are two, of
two cards), ``BitBirch``'s global clustering with the k-means on the card,
and the native host library's build.

Marked ``cuda``: each test skips unless a CUDA device is available.  This
file imports no JAX, so that it also runs where JAX is not installed; on
the card, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from bblean_tpu_torch.fingerprints import make_fake_fingerprints
from bblean_tpu_torch import BatchTree
from bblean_tpu_torch.ops import tile_search as ts

pytestmark = pytest.mark.cuda

SEED = 12620509540149709235


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
    # Pending rows with groups outside the table (clamped as JAX's gather)
    oob = np.array([g + 7, -1, -g - 5, 1 << 30], np.int32)[:m]
    row_group[: len(oob)] = oob
    pending[: len(oob)] = True
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
        (8192, 4, 256, 256, 1, False),  # one group: items of ITEM_ROWS rows
        (2048, 256, 512, 256, 255, False),  # 512-cell tiles, spread
        (2048, 64, 256, 128, 63, False),  # 1024-bit rows
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


@pytest.mark.parametrize(
    "m,g,fc,f8,spread,empty",
    [
        (2048, 64, 256, 256, 3, False),
        (2048, 64, 512, 256, 63, False),
        (1000, 64, 256, 256, 63, False),  # unaligned row count
        (1, 4, 8, 256, 1, False),
        (700, 16, 64, 33, 15, False),  # byte tail: 264-bit rows
        (300, 8, 40, 13, 7, False),
        (512, 8, 256, 256, 7, True),
    ],
)
def test_row_kernel_matches_plain(cuda, m, g, fc, f8, spread, empty) -> None:
    rng = np.random.default_rng(m + fc + f8 + 1)
    args = [torch.from_numpy(a).to(cuda) for a in _case(rng, m, g, fc, f8, spread, empty)]
    args[2][~args[6]] = g + 7  # masked rows may carry any group
    before = ts.row_launches
    got = ts.tile_search_rows(*args)
    assert ts.row_launches == before + 1
    ref = ts.search_tiles_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got[0], ref[0])
    cand = ref[0] > -1.5
    assert torch.equal(got[1][cand], ref[1][cand])
    assert not empty or not bool(cand.any())


def _search(front, args, g):
    if front == "sorted":
        return ts.tile_search_sorted(*args, guard_group=g - 1)
    return ts.tile_search_rows(*args)


@pytest.mark.parametrize("front", ["sorted", "rows"])
@pytest.mark.parametrize("m,spread", [(2048, 3), (512, 63), (40, 1)])
def test_kernel_keeps_the_first_of_tied_cells(cuda, front, m, spread) -> None:
    r"""Cells 1, 5, 9 and 200 of every tile are copies of one another and
    most rows equal that cell: the lowest cell (1) must win, on the
    CUDA-core and on the tensor-core path alike."""
    g, fc, f8 = 64, 256, 256
    rng = np.random.default_rng(m + spread)
    args = list(_case(rng, m, g, fc, f8, spread))
    t_pk, t_slot = args[3], args[5]
    t_pk[: g - 1, 1] = rng.integers(1, 256, (g - 1, f8), dtype=np.uint8)
    for c in (5, 9, 200):
        t_pk[:, c] = t_pk[:, 1]
    t_slot[: g - 1, [1, 5, 9, 200]] = rng.integers(0, 1 << 20, (g - 1, 4))
    args[4] = np.unpackbits(t_pk, axis=-1).sum(-1).astype(np.int32)
    grp = np.clip(args[2], 0, g - 2)
    tie = rng.random(m) < 0.7
    args[0][tie] = t_pk[grp[tie], 1]
    args[1] = np.unpackbits(args[0], axis=1).sum(1).astype(np.int32)
    args[2] = grp.astype(np.int32)
    dev = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda) for a in args]
    got = _search(front, dev, g)
    ref = ts.search_tiles_plain(*dev)
    torch.cuda.synchronize()
    assert torch.equal(got[0], ref[0])
    cand = ref[0] > -1.5
    assert torch.equal(got[1][cand], ref[1][cand])
    won = tie & args[6]
    assert (got[0].cpu().numpy()[won] == 1.0).all()
    np.testing.assert_array_equal(got[1].cpu().numpy()[won], t_slot[grp[won], 1])


@pytest.mark.parametrize("front", ["sorted", "rows"])
@pytest.mark.parametrize("f8,shift,generic", [(256, 0, False), (13, 0, True), (256, 8, True)])
def test_kernel_generic_path_is_counted(cuda, front, f8, shift, generic) -> None:
    r"""F8 % 16 != 0, or rows not 16-byte aligned, take the generic path
    (ordinary loads, its own launch count); the result is the same."""
    m, g, fc = 1000, 32, 96
    rng = np.random.default_rng(f8 + shift)
    args = [torch.from_numpy(a).to(cuda) for a in _case(rng, m, g, fc, f8, 31)]
    if shift:  # the same rows at an address 8 bytes past a 16-byte boundary
        buf = torch.empty(m * f8 + shift, dtype=torch.uint8, device=cuda)
        args[0] = buf[shift:].view(m, f8).copy_(args[0])
    before = ts.generic_launches
    if front == "sorted":  # the wrapper sorts the rows: pass a shifted copy
        key = torch.where(args[6], args[2], g - 1)
        order, skey, items = ts.sorted_search_plan(key)
        srows = args[0][order]
        if shift:
            buf = torch.empty(m * f8 + shift, dtype=torch.uint8, device=cuda)
            srows = buf[shift:].view(m, f8).copy_(srows)
        got = ts.tile_search_planned(
            srows, args[1][order], skey, order, *args[3:], items
        )
    else:
        got = ts.tile_search_rows(*args)
    assert ts.generic_launches == before + generic
    ref = ts.search_tiles_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got[0], ref[0])
    cand = ref[0] > -1.5
    assert torch.equal(got[1][cand], ref[1][cand])


def test_kernel_wrapper_rejects_bad_inputs(cuda) -> None:
    rng = np.random.default_rng(0)
    args = [torch.from_numpy(a).to(cuda) for a in _case(rng, 64, 4, 32, 256, 3)]
    order, skey, items = ts.sorted_search_plan(args[2])
    srows, spops = args[0][order], args[1][order]
    rest = (args[3], args[4], args[5], args[6], items)
    with pytest.raises(ValueError, match="must be"):
        ts.tile_search_planned(srows, spops.long(), skey, order, *rest)
    with pytest.raises(ValueError, match="contiguous"):
        ts.tile_search_planned(srows, spops, skey, order, args[3].transpose(1, 2), *rest[1:])
    with pytest.raises(ValueError, match="CUDA device"):
        ts.tile_search_planned(srows, spops.cpu(), skey, order, *rest)
    with pytest.raises(ValueError, match="items must have"):
        ts.tile_search_planned(srows, spops, skey, order, *rest[:4], items[:-1])
    with pytest.raises(ValueError, match="int32"):
        ts.plan_items(skey.long())


@pytest.mark.parametrize(
    "runs",
    [[1], [64], [65], [3, 64, 1, 129, 7], [1] * 50 + [130], [8192], [2] * 4096,
     [40] * 500, [9000, 1, 11000]],  # the last two: more rows than one pass
)
def test_plan_kernel_matches_plain(cuda, runs) -> None:
    r"""The plan's item table from the kernel equals the plain version's,
    one launch per plan."""
    rng = np.random.default_rng(len(runs))
    groups = np.sort(rng.choice(1 << 20, size=len(runs), replace=False))
    key = np.repeat(groups, runs).astype(np.int32)
    rng.shuffle(key)
    before = ts.plan_launches
    order, skey, items = ts.sorted_search_plan(torch.from_numpy(key).to(cuda))
    assert ts.plan_launches == before + 1
    ref = ts.plan_items_plain(skey)
    torch.cuda.synchronize()
    assert torch.equal(items, ref)
    assert int(items[-1]) == sum(-(-k // ts.ITEM_ROWS) for k in runs)


def test_cpu_and_cuda_fits_give_equal_labels(cuda) -> None:
    fps = make_fake_fingerprints(3000, seed=12620509540149709235)
    labels = []
    for device in ("cpu", cuda):
        tree = BatchTree(2048, threshold=0.3, batch_size=128, route_block=64,
                         initial_capacity=2048, device=device)
        tree.fit_packed(fps, range(len(fps)))
        labels.append(tree.assignments())
    np.testing.assert_array_equal(labels[0], labels[1])


def test_predict_aligned_and_unaligned_batches_agree(cuda) -> None:
    r"""batch=1024 runs the sorted kernel, batch=1000 the per-row kernel;
    slots and sims are identical, and equal the CPU tree's."""
    fps = make_fake_fingerprints(6000, seed=12620509540149709235)
    out = {}
    for device in ("cpu", cuda):
        tree = BatchTree(2048, threshold=0.3, batch_size=1024, device=device)
        tree.fit_packed(fps[:4000], range(4000))
        launches = (ts.launches, ts.row_launches)
        for batch in (1024, 1000):
            out[str(device), batch] = tree.predict_packed(fps[4000:], batch=batch)
        if device != "cpu":
            assert ts.launches > launches[0] and ts.row_launches > launches[1]
    ref_slots, ref_sims = out["cpu", 1024]
    assert (ref_slots >= 0).all()
    for slots, sims in out.values():
        np.testing.assert_array_equal(slots, ref_slots)
        np.testing.assert_array_equal(sims, ref_sims)


# -- side ops and the command line: CPU against CUDA ----------------------------


@pytest.mark.parametrize("n_features", [2048, 264, 100])
def test_popcount_and_tanimoto_equal_on_cpu_and_cuda(cuda, n_features) -> None:
    r"""Integers equal, f32 similarities bit for bit; numpy input goes to
    the card by default, a tensor is used where it lies."""
    from bblean_tpu_torch.ops import popcount, tanimoto

    rng = np.random.default_rng(n_features)
    bits = (rng.random((300, n_features)) < 0.35).astype(np.uint8)
    cents = (rng.random((37, n_features)) < 0.35).astype(np.uint8)
    packed = np.packbits(bits, axis=1)
    calls = [
        lambda **kw: popcount.popcount_device(packed, **kw),
        lambda **kw: popcount.popcount_rows(bits, **kw),
        lambda **kw: tanimoto.tanimoto_packed_arr_vec(packed, packed[3], **kw),
        lambda **kw: tanimoto.intersection_matmul(bits, cents, **kw),
        lambda **kw: tanimoto.tanimoto_matmul(bits, cents, **kw),
    ]
    for call in calls:
        got = call()
        assert got.device.type == "cuda"
        assert torch.equal(got.cpu(), call(device="cpu"))
    on_card = tanimoto.tanimoto_matmul(
        torch.from_numpy(bits).to(cuda), torch.from_numpy(cents).to(cuda)
    )
    assert on_card.device.type == "cuda"
    assert torch.equal(on_card.cpu(), calls[4](device="cpu"))


def test_kmeans_on_cuda(cuda) -> None:
    r"""One seed gives the same draws on both devices: on well-separated
    blobs the labels are equal; two calls on the card are equal on any
    data; TF32, if the process has it on, is kept out of the distances."""
    from bblean_tpu_torch.ops.kmeans import kmeans_fit_predict

    rng = np.random.default_rng(0)
    centers = rng.normal(size=(4, 64)) * 10.0
    pts = np.concatenate([c + rng.normal(size=(50, 64)) for c in centers]).astype(np.float32)
    labels = kmeans_fit_predict(pts, 4, seed=1)
    np.testing.assert_array_equal(labels, kmeans_fit_predict(pts, 4, seed=1, device="cpu"))
    noise = rng.random((3000, 96)).astype(np.float32)
    first = kmeans_fit_predict(noise, 25, seed=2)
    np.testing.assert_array_equal(first, kmeans_fit_predict(noise, 25, seed=2))
    allowed = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        np.testing.assert_array_equal(first, kmeans_fit_predict(noise, 25, seed=2))
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allowed


def test_tsne_on_cuda(cuda) -> None:
    r"""10 iterations agree with the CPU to 1e-3 of the embedding's scale
    (the descent amplifies rounding after that); a full run is finite and
    the same on two calls."""
    from bblean_tpu_torch.ops.tsne import tsne_embed

    pts = make_fake_fingerprints(300, n_features=256, seed=3, pack=False).astype(np.float32)
    for knobs in (dict(), dict(multiscale=True, dof=0.8, exaggeration=1.5, early_iter=5)):
        got = tsne_embed(pts, n_iter=10, perplexity=15.0, **knobs)
        ref = tsne_embed(pts, n_iter=10, perplexity=15.0, device="cpu", **knobs)
        assert np.abs(got - ref).max() <= 1e-3 * np.abs(ref).max()
    full = tsne_embed(pts, n_iter=300, do_pca_init=False, seed=4)
    assert full.shape == (300, 2) and np.isfinite(full).all()
    np.testing.assert_array_equal(full, tsne_embed(pts, n_iter=300, do_pca_init=False, seed=4))


def test_cli_run_writes_the_same_pickles_on_cpu_and_cuda(cuda, tmp_path) -> None:
    import json

    from bblean_tpu_torch.cli import main

    path = tmp_path / "fps.npy"
    np.save(path, make_fake_fingerprints(3000, seed=12620509540149709235))
    outs = {}
    for device in ("cpu", "cuda"):
        outs[device] = tmp_path / device
        before = (ts.launches, ts.row_launches, ts.plan_launches)
        main(["run", str(path), "-o", str(outs[device]), "-t", "0.3", "--engine", "batch",
              "--batch-size", "256", "--refine-num", "1", "--no-monitor-mem", "-V",
              "--device", device])
        after = (ts.launches, ts.row_launches, ts.plan_launches)
        assert (after > before) == (device == "cuda")
    for name in ("clusters.pkl", "cluster-centroids-packed.pkl"):
        assert (outs["cpu"] / name).read_bytes() == (outs["cuda"] / name).read_bytes()
    config = json.loads((outs["cuda"] / "config.json").read_text())
    assert config["device"] == "cuda" and config["accelerators"]
    assert config["device_memory"]["peak_bytes_in_use"] > 0
    assert "device_memory" not in json.loads((outs["cpu"] / "config.json").read_text())


def _sharded_labels(devices, fps):
    from bblean_tpu_torch.parallel import ShardedForest, get_mesh

    forest = ShardedForest(
        2048, get_mesh(devices=devices), threshold=0.3, batch_size=512,
        scan_batches=2, route_block=512,
    )
    forest.fit_packed(fps)
    forest.merge()
    return forest, forest.labels()


def test_sharded_merge_on_a_card_equals_the_cpu(cuda) -> None:
    r"""Four shards of one card merge into the CPU shards' labels, and the
    merge's row-level inserts launch the kernels."""
    fps = make_fake_fingerprints(12_000, seed=5)
    _cpu_forest, ref = _sharded_labels(["cpu"] * 4, fps)
    before, generic = ts.launches + ts.row_launches, ts.generic_launches
    forest, got = _sharded_labels(["cuda:0"] * 4, fps)
    np.testing.assert_array_equal(got, ref)
    assert ts.launches + ts.row_launches > before and ts.generic_launches == generic
    assert forest.states[0].n.device.type == "cuda" and forest.states[1:] == [None] * 3
    rows = sum(s["rows"] for r in forest.merge_stats for s in r["receivers"].values())
    assert rows > 0 and len(forest.merge_stats) == 2
    _forest, from_tensor = _sharded_labels(["cuda:0"] * 4, torch.from_numpy(fps).to(cuda))
    np.testing.assert_array_equal(from_tensor, ref)


def test_sharded_merge_across_two_cards(cuda) -> None:
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from bblean_tpu_torch.parallel import get_mesh

    fps = make_fake_fingerprints(12_000, seed=5)
    _ref_forest, ref = _sharded_labels(["cuda:0"] * 4, fps)
    forest, got = _sharded_labels(["cuda:0", "cuda:1", "cuda:0", "cuda:1"], fps)
    np.testing.assert_array_equal(got, ref)
    assert forest.states[0].n.device == torch.device("cuda", 0)
    assert get_mesh(2).devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    with pytest.raises(ValueError, match="Requested"):
        get_mesh(torch.cuda.device_count() + 1)


def test_global_clustering_kmeans_runs_on_the_card(cuda) -> None:
    r"""``global_clustering(method="kmeans-tpu")`` with no ``device=`` works
    on the card: the k-means launches kernels and allocates there."""
    import warnings

    from bblean_tpu_torch import BitBirch

    fps = make_fake_fingerprints(3000, seed=SEED)
    tree = BitBirch(threshold=0.5).fit(fps)
    runs = []
    for _ in range(2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_stats()["allocation.all.allocated"]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            tree.global_clustering(20, method="kmeans-tpu", seed=0)
        assert torch.cuda.memory_stats()["allocation.all.allocated"] > before
        assert torch.cuda.max_memory_allocated() > 0
        labels = tree.get_assignments(global_clusters=True)
        assert labels.shape == (3000,) and labels.min() >= 1 and labels.max() <= 20
        runs.append(labels)
    np.testing.assert_array_equal(runs[0], runs[1])


def test_native_library_builds_and_equals_the_python_engine(cuda, monkeypatch) -> None:
    r"""The card's machine has a host C++ compiler (``nvcc`` needs one): the
    native library builds there, is the one loaded, and gives the Python
    engine's labels."""
    from bblean_tpu_torch import BitBirch, _native

    monkeypatch.delenv("BBLEAN_TPU_NO_EXTENSIONS", raising=False)
    fps = make_fake_fingerprints(2000, seed=SEED)
    native = BitBirch(threshold=0.3).fit(fps)
    assert native.engine_name == "native"
    path = _native.loaded_lib_path()
    assert path is not None and path.parent.name == "build" and path.parent.parent.name == "csrc"
    assert path.parent.parent.parent.name == "bblean_tpu_torch"
    monkeypatch.setenv("BBLEAN_TPU_NO_EXTENSIONS", "1")
    python = BitBirch(threshold=0.3).fit(fps)
    assert python.engine_name == "python"
    assert native.get_cluster_mol_ids() == python.get_cluster_mol_ids()
