r"""The port on a CUDA card: the tile-search kernels (sorted and per-row
launch modes), the sort plan's item-table kernel and the route kernel
(both epilogues: the route's first argmax and the merge's best sim; the
TMA path and the generic one, near ties, the clamped last block, ragged
rows and more work units than SMs) and the prefix-commit kernel (the
insert round's screen and two passes, all six criteria, every layout of
segments, sums past 2^16, the vote's edge, several column tiles, with and
without ``need``, the look-back's stress cases, inside a captured CUDA
graph), the leader election (every layout, from the packed rows or sims,
with and without a plan, one group of 8,192 rejected rows, tile edges,
ties across tiles, byte tails, in a captured graph), the pool and tile
writes (every layout, byte tails, writes past capacity, in a captured
graph) and the step's refresh (every layout, tiles of 256 and 512 cells,
byte tails, any row order, a mid-fit step of the 1M configuration, two
launches with no sync or allocation, a side stream) against their plain
versions, CPU and CUDA fits giving the
same labels, predict giving the same answer at aligned and unaligned
batch sizes, the side ops (popcount, Tanimoto, k-means, t-SNE) against the
same functions on the CPU, one command-line run on each device, and the
sharded engine's merge on shards of one card (and, where there are two, of
two cards), ``BitBirch``'s global clustering with the k-means on the card,
the native host library's build, and the batch step's CUDA graphs (a
replayed round bit-equal to a dispatched one, a fit whose tables grow
equal to the CPU's, and launch counts through replays equal to a
dispatched fit's).

Marked ``cuda``: each test skips unless a CUDA device is available.  This
file imports no JAX, so that it also runs where JAX is not installed; on
the card, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import functools

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


# -- the batch step's rounds and split passes as CUDA graphs ---------------------


def _graph_counts():
    from bblean_tpu_torch.engine import graphs

    return graphs.warmups, graphs.captures, graphs.replays


def test_replayed_round_equals_dispatched_round(cuda) -> None:
    r"""Wide and narrow rounds through the runner (warm-up, capture, then
    replays) against the same rounds dispatched on a clone of the state
    and of the step's buffers: every table and buffer equal, bit for bit,
    after every round."""
    from bblean_tpu_torch.engine import batch as engine, graphs

    fps = make_fake_fingerprints(9192, seed=SEED)
    tree = BatchTree(2048, threshold=0.3, batch_size=1024, device=cuda)
    tree.fit_packed(fps[:8000], range(8000))
    m, narrow = 1024, 256
    valid = torch.ones(m, dtype=torch.bool, device=cuda)
    valid[-7:] = False
    rows = engine._prep_fp_rows(torch.from_numpy(fps[8000 : 8000 + m]).to(cuda), valid, 2048)
    thr, tol = tree._scalars()
    bufs = engine._stage_step(tree.state, *rows, thr, tol, block=tree.route_block)
    tables = engine._tables(tree.state)
    twin_tables = tuple(t.clone() for t in tables)
    twin_bufs = graphs.Buffers((k, v.clone()) for k, v in bufs.items())
    wide = ("wide", "diameter"), functools.partial(engine._wide_round, criterion="diameter")
    compact = ("narrow", "diameter", narrow), functools.partial(
        engine._narrow_round, criterion="diameter", narrow=narrow
    )
    before = _graph_counts()
    for name, fn in [wide] * 3 + [compact] * 3:
        engine._carry(bufs, graphs.run(name, fn, tables, bufs))
        engine._carry(twin_bufs, fn(twin_tables, twin_bufs))
        torch.cuda.synchronize()
        for field, a, b in zip(engine._TABLES, tables, twin_tables):
            assert torch.equal(a, b), (name, field)
        for k in bufs:
            assert torch.equal(bufs[k], twin_bufs[k]), (name, k)
    assert _graph_counts()[2] - before[2] >= 4  # at least two replays of each


def test_kernels_launch_on_the_capture_stream(cuda, monkeypatch) -> None:
    r"""Inside a capture the tile-search wrapper's ctypes launch takes the
    runner's side stream (torch's current stream there), in the default
    global capture mode; every launch of the fit is on that stream or the
    default one."""
    from bblean_tpu_torch.engine import graphs

    seen = []
    launch = ts._launch

    def recording(*args):
        seen.append((torch.cuda.current_stream().cuda_stream, torch.cuda.is_current_stream_capturing()))
        return launch(*args)

    monkeypatch.setattr(ts, "_launch", recording)
    fps = make_fake_fingerprints(5000, seed=SEED)
    tree = BatchTree(2048, threshold=0.3, batch_size=512, device=cuda)
    tree.fit_packed(fps, range(len(fps)))
    side = graphs._streams[torch.device(cuda.type, torch.cuda.current_device())].cuda_stream
    captured = [stream for stream, capturing in seen if capturing]
    assert captured and set(captured) == {side}
    assert {stream for stream, _c in seen} <= {side, torch.cuda.default_stream().cuda_stream}


def test_fit_with_forced_growth_equals_cpu_labels(cuda) -> None:
    r"""A fit in two parts with every table grown between them: the growth
    gives the rounds new keys (captured again), and the labels stay the
    CPU's."""
    fps = make_fake_fingerprints(6000, seed=SEED)
    labels, captures = [], []
    for device in ("cpu", cuda):
        before = _graph_counts()
        tree = BatchTree(2048, threshold=0.3, batch_size=256, route_block=64,
                         tile=64, fanout=48, device=device)
        tree.fit_packed(fps[:3000], range(3000))
        shapes = tree.state.n.shape[0], tree.state.g_ls.shape[0], tree.state.ls.shape[0]
        tree._ensure_capacity(2 * max(shapes))
        grown = tree.state.n.shape[0], tree.state.g_ls.shape[0], tree.state.ls.shape[0]
        assert all(b > a for a, b in zip(shapes, grown)), (shapes, grown)
        tree.fit_packed(fps[3000:], range(3000, 6000))
        labels.append(tree.assignments())
        captures.append(_graph_counts()[1] - before[1])
    np.testing.assert_array_equal(labels[0], labels[1])
    assert captures[1] > 3, captures  # the keys of the grown tables captured again


def test_graphed_fit_counts_equal_dispatched_counts(cuda, monkeypatch) -> None:
    r"""A fit through the runner launches (by the counters) exactly what
    the same fit launches with every program dispatched, and gives the
    same labels."""
    from bblean_tpu_torch.engine import graphs
    from bblean_tpu_torch.ops import route

    fps = make_fake_fingerprints(20_000, seed=SEED)

    def counts():
        return (ts.launches, ts.row_launches, ts.plan_launches, ts.generic_launches,
                route.route_launches, route.wgmma_launches)

    out = []
    for dispatched in (False, True):
        with monkeypatch.context() as mp:
            if dispatched:
                mp.setattr(graphs, "run", lambda name, fn, tables, bufs: fn(tables, bufs))
            before, g0 = counts(), _graph_counts()
            tree = BatchTree(2048, threshold=0.3, batch_size=1024, device=cuda)
            tree.fit_packed(fps, range(len(fps)))
            labels = tree.assignments()
            out.append((tuple(b - a for a, b in zip(before, counts())), labels))
            if not dispatched:
                assert _graph_counts()[2] > g0[2]
    (graphed, labels_g), (plain, labels_d) = out
    assert graphed == plain and graphed[0] > 0 and graphed[1] > 0
    np.testing.assert_array_equal(labels_g, labels_d)


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


# ---- the route kernel (csrc/route.cu) ----


def _route_case(rng, m, f, g_cap, ties=()):
    r"""0/1 rows and centroids at 20% density on the card; centroid 3 copied
    to the columns in ``ties``, a third of the rows copies of it, row 5 and
    centroid 7 all zero, every third row not pending."""
    rows = (rng.random((m, f)) < 0.2).astype(np.int8)
    cent = (rng.random((g_cap, f)) < 0.2).astype(np.int8)
    cent[list(ties)] = cent[3]
    cent[7] = 0
    rows[1::3] = cent[3]
    rows[min(5, m - 1)] = 0
    pending = np.ones(m, bool)
    pending[::3] = False
    pending[0] = True
    arrays = (rows, rows.sum(1).astype(np.int32), cent, cent.sum(1).astype(np.int32), pending)
    return [torch.from_numpy(a).to("cuda") for a in arrays]


def _route_both(args, g_num, block):
    r"""Both kernels and both plain versions on the same inputs; each
    wrapper must count one launch (none when no group is live), on the TMA
    path exactly where F % 16 == 0 and both tables are 16-byte aligned."""
    from bblean_tpu_torch.ops import route

    rows, pops, cent, cpops, pending = args
    before = (route.route_launches, route.best_sim_launches, route.wgmma_launches)
    got = (
        route.route_groups(rows, pops, cent, cpops, g_num, pending, block),
        route.best_group_sim(rows, pops, cent, cpops, g_num, block),
    )
    launched = int(g_num > 0)
    assert (route.route_launches, route.best_sim_launches) == (before[0] + launched, before[1] + launched)
    tma = rows.shape[1] % 16 == 0 and rows.data_ptr() % 16 == 0 and cent.data_ptr() % 16 == 0
    assert route.wgmma_launches == before[2] + 2 * launched * tma
    ref = (
        route.route_groups_plain(rows, pops, cent, cpops, g_num, pending, block),
        route.best_group_sim_plain(rows, pops, cent, cpops, g_num, block),
    )
    torch.cuda.synchronize()
    return got, ref


@pytest.mark.parametrize(
    "m,f,g_cap,g_num,block",
    [
        (37, 2048, 64, 45, 16),  # several blocks, the last one partial
        (37, 2048, 64, 60, 24),  # the clamped last block
        (37, 2048, 64, 64, 24),  # clamped, every group live
        (37, 264, 64, 50, 128),  # block wider than the table (generic path)
        (37, 100, 64, 0, 16),  # no live group: no launch
        (37, 100, 64, 1, 16),  # one live group (generic path)
        (300, 2048, 1024, 1000, 1000),  # clamped by 976 rows
        (8192, 2048, 4096, 3000, 1024),  # the engine's M and F
        (1, 2048, 256, 200, 64),
    ],
)
def test_route_kernel_matches_plain(cuda, m, f, g_cap, g_num, block) -> None:
    from bblean_tpu_torch.ops import route

    rng = np.random.default_rng(m + f + g_num + block)
    args = _route_case(rng, m, f, g_cap, ties=[t for t in (20, 41, 59) if t < g_cap])
    generic = route.generic_launches
    (idx, sim), (ref_idx, ref_sim) = _route_both(args, g_num, block)
    assert route.generic_launches == generic + 2 * (f % 16 != 0 and g_num > 0)
    assert idx.dtype == torch.int32 and sim.dtype == torch.float32
    assert torch.equal(idx, ref_idx)
    assert torch.equal(sim.view(torch.int32), ref_sim.view(torch.int32))


def test_route_kernel_keeps_the_first_of_ties_across_chunks(cuda) -> None:
    r"""At M = 8192 the live columns split into column ranges (the units'
    second coordinate, ``route._plan``): copies of centroid 3 in other
    blocks and ranges tie at 1.0, and column 3 must win; the main path's
    width takes no generic launch."""
    from bblean_tpu_torch.ops import route

    m, g_num = 8192, 4096
    plan = route._plan(m, g_num, 0, 0, torch.cuda.get_device_properties(0).multi_processor_count)
    assert plan.n_ranges > 1
    ties = [3 + k * plan.span + 5 for k in range(1, plan.n_ranges)]
    args = _route_case(np.random.default_rng(9), m, 2048, 8192, ties=[20, 1500, *ties])
    generic = route.generic_launches
    (idx, sim), (ref_idx, ref_sim) = _route_both(args, g_num, 1024)
    assert route.generic_launches == generic
    assert torch.equal(idx, ref_idx) and torch.equal(sim, ref_sim)
    copies = args[4].clone()
    copies[0::3] = False
    copies[2::3] = False
    assert bool((idx[copies] == 3).all()) and bool((sim[1::3] == 1.0).all())


def test_route_kernel_unaligned_rows_take_the_generic_path(cuda) -> None:
    from bblean_tpu_torch.ops import route

    args = _route_case(np.random.default_rng(4), 500, 2048, 512)
    buf = torch.empty(500 * 2048 + 8, dtype=torch.int8, device=cuda)
    args[0] = buf[8:].view(500, 2048).copy_(args[0])
    generic = route.generic_launches
    (idx, sim), (ref_idx, ref_sim) = _route_both(args, 400, 128)
    assert route.generic_launches == generic + 2
    assert torch.equal(idx, ref_idx) and torch.equal(sim, ref_sim)


def test_route_wrapper_rejects_bad_inputs(cuda) -> None:
    from bblean_tpu_torch.ops import route

    rows, pops, cent, cpops, pending = _route_case(np.random.default_rng(0), 64, 256, 128)
    with pytest.raises(ValueError, match="must be"):
        route.route_groups(rows.int(), pops, cent, cpops, 100, pending, 64)
    with pytest.raises(ValueError, match="must be"):
        route.best_group_sim(rows, pops.long(), cent, cpops, 100, 64)
    with pytest.raises(ValueError, match="contiguous"):
        route.route_groups(rows, pops, cent.t().contiguous().t(), cpops, 100, pending, 64)
    with pytest.raises(ValueError, match="CUDA device"):
        route.route_groups(rows, pops, cent, cpops.cpu(), 100, pending, 64)
    with pytest.raises(ValueError, match="g_num"):
        route.best_group_sim(rows, pops, cent, cpops, 129, 64)
    with pytest.raises(ValueError, match="share a width"):
        route.best_group_sim(rows[:, :128].contiguous(), pops, cent, cpops, 100, 64)
    with pytest.raises(ValueError, match="pending must have"):
        route.route_groups(rows, pops, cent, cpops, 100, pending[:-1], 64)


@pytest.mark.parametrize(
    "m,g_cap,g_num,block",
    [
        (37, 4096, 3000, 1024),  # M below one row tile
        (8191, 4096, 4096, 1024),  # M one short of 64 row tiles
        (8192, 4096, 4096, 1000),  # clamped last block at 4,000: on no tile boundary
        (8192, 65536, 65536, 1000),  # clamped at 65,000 (phase 2d's case)
        (300, 1024, 100, 1024),  # g_num below one column tile
        (16384, 16384, 755, 1024),  # the merge's shape (Q = 16,384)
    ],
)
def test_route_tma_path_matches_plain(cuda, m, g_cap, g_num, block) -> None:
    r"""The TMA path on ragged rows, the clamped last block where no tile
    divides its first column, fewer live groups than one column tile and
    the merge's shape: bit-equal to the plain versions, no generic launch."""
    from bblean_tpu_torch.ops import route

    rng = np.random.default_rng(m + g_cap + g_num + block)
    args = _route_case(rng, m, 2048, g_cap, ties=[20, 41, 2000 % g_cap])
    last_start, shift = route._last_block(g_cap, g_num, block)
    if block == 1000:
        assert shift != 0 and last_start % route.TILE_COLS != 0
    generic = route.generic_launches
    (idx, sim), (ref_idx, ref_sim) = _route_both(args, g_num, block)
    assert route.generic_launches == generic
    assert torch.equal(idx, ref_idx)
    assert torch.equal(sim.view(torch.int32), ref_sim.view(torch.int32))


def test_route_tma_path_with_more_units_than_sms(cuda) -> None:
    r"""20,000 rows (157 row tiles) against 3,000 live groups: more work
    units than SMs, so the persistent blocks walk several units each."""
    from bblean_tpu_torch.ops import route

    m, g_num = 20_000, 3000
    plan = route._plan(m, g_num, 0, 0, torch.cuda.get_device_properties(0).multi_processor_count)
    assert plan.units > plan.grid
    args = _route_case(np.random.default_rng(11), m, 2048, 4096, ties=[20, 1500])
    (idx, sim), (ref_idx, ref_sim) = _route_both(args, g_num, 1024)
    assert torch.equal(idx, ref_idx)
    assert torch.equal(sim.view(torch.int32), ref_sim.view(torch.int32))


@pytest.mark.parametrize("cols", [(10, 20), (100, 3900), (20, 10)])
def test_route_tma_path_keeps_the_first_column_of_a_near_tie(cuda, cols) -> None:
    r"""8192-bit rows: centroid ``cols[0]`` and centroid ``cols[1]`` meet
    the even rows in two exact fractions that differ but round to one f32
    (``chip_smoke.route_near_tie``), the larger at ``cols[1]``.  The route
    keeps the earlier column, as the plain version does: a rule that
    skipped divisions by the exact fractions alone would take the larger
    one where it comes later."""
    import chip_smoke
    from bblean_tpu_torch.ops import route

    arrays = chip_smoke.route_near_tie_inputs(np.random.default_rng(5), 512, 8192, 4096, cols)
    args = [torch.from_numpy(a).to(cuda) for a in arrays]
    (idx, sim), (ref_idx, ref_sim) = _route_both(args, 4096, 1024)
    assert torch.equal(idx, ref_idx)
    assert torch.equal(sim.view(torch.int32), ref_sim.view(torch.int32))
    tied = args[4].clone()
    tied[1::2] = False
    assert bool((idx[tied] == min(cols)).all())


@functools.lru_cache(maxsize=4)
def _prefix_case(m, f, layout, big=False, vote_edge=False):
    import chip_smoke

    rng = np.random.default_rng(m + f + len(layout))
    return chip_smoke.prefix_commit_case(rng, m, f, layout, big=big, vote_edge=vote_edge)


def _prefix_both(criterion, case, device, need) -> None:
    r"""The round's three calls on ``case`` (with ``need`` as the engine
    passes it, or without): the kernel's moments and accept masks equal
    the plain version's; one launch a call (none for never-merge, which
    has no moments)."""
    import chip_smoke
    from bblean_tpu_torch.ops import prefix_commit as pc
    from bblean_tpu_torch.ops.merges import moment_count

    for mode, (args, nom_n) in chip_smoke.prefix_commit_uses(criterion, case, device, need).items():
        before = pc.launches
        got = pc.prefix_commit_moments(*args)
        assert pc.launches == before + (moment_count(criterion) > 0)
        ref = pc.prefix_commit_moments_plain(*args)
        assert torch.equal(got, ref), mode
        assert torch.equal(
            chip_smoke.prefix_commit_accept(args, nom_n, got),
            chip_smoke.prefix_commit_accept(args, nom_n, ref),
        ), mode


@pytest.mark.parametrize(
    "criterion",
    ["diameter", "radius", "tolerance-diameter", "tolerance-radius", "tolerance-legacy", "never-merge"],
)
@pytest.mark.parametrize("m,f,layout", [(8192, 2048, "t=0.3 runs"), (2048, 2048, "mixed")])
def test_prefix_commit_kernel_matches_plain(cuda, m, f, layout, criterion) -> None:
    r"""The wide and the narrow rounds' shapes: screen, pass 1 and pass 2
    bit-equal to the plain version (moments and masks), with and without
    ``need``."""
    for need in (False, True):
        _prefix_both(criterion, _prefix_case(m, f, layout), cuda, need)


@pytest.mark.parametrize(
    "m,f,layout,kw",
    [
        (2048, 2048, "one segment", {}),  # one segment of every row
        (2048, 2048, "none accepted", {}),
        (2048, 2048, "mixed", {"big": True}),  # sums past 2^16, Ksq past 2^31
        (512, 2048, "singletons", {"vote_edge": True}),
        (1000, 100, "t=0.3 runs", {}),  # F % 4 != 0: scalar loads
        (300, 2050, "mixed", {}),  # two column tiles adding into the moments
        (600, 4100, "one segment", {}),  # three column tiles, a 4-column tail
        (1, 2048, "singletons", {}),
    ],
)
def test_prefix_commit_kernel_edges(cuda, m, f, layout, kw) -> None:
    case = _prefix_case(m, f, layout, **kw)
    for criterion in ("diameter", "tolerance-radius", "tolerance-legacy", "radius"):
        for need in (False, True):
            _prefix_both(criterion, case, cuda, need)


@pytest.mark.parametrize("kind", ["one segment", "chunk-aligned segments",
                                  "long stretches without need", "zero stretches",
                                  "screen stretches"])
def test_prefix_commit_lookback_stress(cuda, kind) -> None:
    r"""The look-back across chunks (``chip_smoke.prefix_lookback_case`` at
    8,187 rows, which no chunk divides): one segment of every row,
    segments that start exactly at chunk boundaries, long stretches of
    chunks with no needed row and of chunks with nothing to read, the
    screen with needed rows at both ends; bit-equal to the plain version
    on each of 50 launches and of 20 replays of a captured CUDA graph."""
    import chip_smoke

    args = chip_smoke.prefix_stress_args(np.random.default_rng(41), kind, cuda)
    chip_smoke.prefix_stress_check(args)


def test_prefix_commit_kernel_in_a_cuda_graph(cuda) -> None:
    r"""Captured in a CUDA graph (as the engine's rounds are), a pass
    replays to the plain version's moments, also after new sums are
    copied into the captured inputs."""
    import chip_smoke
    from bblean_tpu_torch.ops import prefix_commit as pc

    case = _prefix_case(2048, 2048, "t=0.3 runs")
    args, _nom = chip_smoke.prefix_commit_uses("tolerance-radius", case, cuda, True)["pass 1"]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        pc.prefix_commit_moments(*args)  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = pc.prefix_commit_moments(*args)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, pc.prefix_commit_moments_plain(*args))
        args[1].copy_(torch.roll(args[1], 1, dims=0))  # new row sums, same buffer


def test_prefix_commit_wrapper_rejects_bad_inputs(cuda) -> None:
    import chip_smoke
    from bblean_tpu_torch.ops import prefix_commit as pc

    args, _nom = chip_smoke.prefix_commit_uses("diameter", _prefix_case(64, 64, "mixed"), cuda, True)["pass 1"]
    bad = {
        1: args[1].to(torch.int64),  # row sums' dtype
        2: args[2].t(),  # not contiguous
        3: args[3].cpu(),  # another device
        5: args[5][:-1],  # the order's length
        8: args[8].to(torch.int32),  # need's dtype
    }
    for i, t in bad.items():
        with pytest.raises(ValueError):
            pc.prefix_commit_moments(*args[:i], t, *args[i + 1:])


@pytest.mark.parametrize("layout", ["one group", "t=0.3 groups", "fit round", "ties", "force lead", "none rejected"])
@pytest.mark.parametrize("m", [8192, 2048])
def test_leader_election_kernel_matches_plain(cuda, m, layout) -> None:
    r"""Every election layout at the wide and narrow rounds' widths, in
    both ways a round calls it (the step's plan; a wider step's plan
    through the selection of its rows): leads on every row and lead_of /
    best_lead_sim on the rejected rows that do not lead bit-equal to the
    plain version, 0 / _NEG on the others, one launch a call."""
    import chip_smoke

    case = chip_smoke.election_case(np.random.default_rng(43), m, 2048, layout)
    for mode, plan in chip_smoke.ELECTION_MODES.items():
        chip_smoke._election_check(chip_smoke.election_args(case, cuda, plan), f"{layout} {mode}")


@pytest.mark.parametrize("m,f", [(300, 100), (1, 2048), (2048, 264), (2048, 100)])
def test_leader_election_kernel_edges(cuda, m, f) -> None:
    r"""Byte tails in the packed rows (264 and 100 bits: staged a byte at a
    time) and a single row."""
    import chip_smoke

    case = chip_smoke.election_case(np.random.default_rng(44), m, f, "t=0.3 groups")
    for plan in ("wide", "narrow"):
        chip_smoke._election_check(chip_smoke.election_args(case, cuda, plan), f"M={m} F={f} {plan}")


def _election_groups(rng, sizes, f=2048, dup=False, force=0.0):
    r"""An election case of ``election_case``'s form whose rows all are
    valid and rejected, on groups of the given sizes (group g holds
    sizes[g] rows, interleaved at random); ``dup``: every row of a group a
    copy of its prototype (every pair ties at 1.0)."""
    group = rng.permutation(np.repeat(np.arange(len(sizes)), sizes)).astype(np.int32)
    m = len(group)
    protos = rng.random((len(sizes), f)) < 0.25
    flip = rng.random((m, f)) < (0.0 if dup else 0.12)
    bits = protos[group] ^ flip
    ones = np.ones(m, bool)
    return (
        ones, rng.random(m) < force, group, ones, np.packbits(bits, axis=1),
        bits.sum(1).astype(np.int32),
    )


def test_leader_election_one_group_of_8192_rejected_rows(cuda) -> None:
    r"""A fit's first batch: 8,192 rejected rows on one group, 33.5M pairs
    over 32,896 tiles, on a wide round's plan and on a narrow round's."""
    import chip_smoke

    case = _election_groups(np.random.default_rng(50), [8192])
    assert chip_smoke.election_pairs(case[0], case[2]) == 8192 * 8191 // 2
    for plan in ("wide", "narrow"):
        chip_smoke._election_check(chip_smoke.election_args(case, cuda, plan), f"one group {plan}")


def test_leader_election_rejected_rows_on_tile_edges(cuda) -> None:
    r"""Groups whose rejected rows end on, just before and just after the
    kernel's tile edges (32 rows a side): 1, 31, 32, 33, 63, 64, 65, 96 and
    97 rows, and a few struck twice."""
    import chip_smoke

    case = _election_groups(np.random.default_rng(51), [1, 31, 32, 33, 63, 64, 65, 96, 97], force=0.1)
    for mode, plan in chip_smoke.ELECTION_MODES.items():
        chip_smoke._election_check(chip_smoke.election_args(case, cuda, plan), f"tile edges {mode}")


def test_leader_election_ties_across_tiles(cuda) -> None:
    r"""Every row of a group a copy of one prototype (each pair ties at
    1.0), groups of 200 and 90 rows over several tiles, half the rows
    struck twice: each row's leader is its lowest leader below it, across
    tiles and blocks."""
    import chip_smoke
    from bblean_tpu_torch.ops import leader_election as le

    case = _election_groups(np.random.default_rng(52), [200, 90], dup=True, force=0.5)
    for mode, plan in chip_smoke.ELECTION_MODES.items():
        args = chip_smoke.election_args(case, cuda, plan)
        chip_smoke._election_check(args, f"ties {mode}")
        leads, lead_of, best = (t.cpu().numpy() for t in le.elect_leaders(*args))
        c = ~leads
        assert c.sum() > 50 and (best[c] == 1.0).all()
        group = case[2]
        for j in np.flatnonzero(c):
            assert lead_of[j] == np.flatnonzero(leads & (group == group[j]))[0]


def test_leader_election_in_a_cuda_graph(cuda) -> None:
    import chip_smoke

    for layout in ("t=0.3 groups", "fit round"):
        case = chip_smoke.election_case(np.random.default_rng(45), 2048, 2048, layout)
        for plan in ("wide", "narrow"):
            chip_smoke._election_replays(chip_smoke.election_args(case, cuda, plan))


def test_leader_election_wrapper_rejects_bad_inputs(cuda) -> None:
    import chip_smoke
    from bblean_tpu_torch.ops import leader_election as le

    case = chip_smoke.election_case(np.random.default_rng(46), 64, 64, "t=0.3 groups")
    args = chip_smoke.election_args(case, cuda, "wide")
    order, skey, sel = chip_smoke.election_args(case, cuda, "narrow")[7]
    bad = {
        0: args[0].to(torch.int32),  # rejected's dtype
        2: args[2].cpu(),  # another device
        3: args[3][None],  # the threshold's shape
        4: torch.zeros((64, 64), dtype=torch.float32, device=cuda),  # sims: the kernel takes packed rows
        5: args[5].t(),  # not contiguous
        6: None,  # no popcounts
        7: (args[7][0][:-1], args[7][1][:-1]),  # the plan's length
    }
    for i, t in bad.items():
        with pytest.raises(ValueError):
            le.elect_leaders(*args[:i], t, *args[i + 1:])
    for plan in (
        None,  # no plan
        (order, skey),  # a wider step's plan without the selection
        (order, skey, sel.to(torch.int32)),  # the selection's dtype
        (order, skey, sel[:-1]),  # the selection's length
    ):
        with pytest.raises(ValueError):
            le.elect_leaders(*args[:7], plan)


@pytest.mark.parametrize("layout", ["t=0.3 runs", "one segment", "singletons", "edges", "mixed"])
@pytest.mark.parametrize("m,f", [(8192, 2048), (2048, 2048), (2048, 264), (300, 100)])
def test_commit_writes_kernel_matches_plain(cuda, m, f, layout) -> None:
    r"""Every writes layout at the rounds' widths and at 264 and 100 bits
    (scalar loads, byte tails; rows read packed and as int32 sums): every
    table bit-equal to the plain version's, the guard row, cell and slot
    unchanged, one launch."""
    import chip_smoke

    case = chip_smoke.commit_writes_case(np.random.default_rng(47), m, f, layout)
    chip_smoke._writes_check(chip_smoke.writes_args(case, cuda), f"M={m} F={f} {layout}")


def test_commit_writes_in_a_cuda_graph(cuda) -> None:
    import chip_smoke

    case = chip_smoke.commit_writes_case(np.random.default_rng(48), 2048, 2048, "t=0.3 runs")
    chip_smoke._writes_replays(chip_smoke.writes_args(case, cuda))


def test_commit_writes_wrapper_rejects_bad_inputs(cuda) -> None:
    import chip_smoke
    from bblean_tpu_torch.ops import commit_writes as cw

    case = chip_smoke.commit_writes_case(np.random.default_rng(49), 64, 64, "t=0.3 runs")
    args = chip_smoke.writes_args(case, cuda)
    at = {name: i for i, name in enumerate(chip_smoke.WRITES_ARGS)}
    bad = {
        0: args[0].to(torch.int64),  # the pool's dtype
        1: args[1][..., :-1],  # the tiles' bytes
        at["n"]: args[at["n"]][:-1],  # the counts' length
        at["row_ls"]: args[at["row_ls"]].t().contiguous().t(),  # not contiguous
        at["row_pk"]: args[at["row_pk"]][:, :-1],  # the packed rows' bytes
        at["row_single"]: args[at["row_single"]].to(torch.uint8),  # the flag's dtype
        at["aorder"]: args[at["aorder"]].to(torch.int32),  # the order's dtype
        at["committed"]: args[at["committed"]].cpu(),  # another device
        at["jseg"]: args[at["jseg"]][:-1],  # a row input's length
    }
    for i, t in bad.items():
        with pytest.raises(ValueError):
            cw.commit_writes(*args[:i], t, *args[i + 1:])


REFRESH_LAYOUTS = (
    "t=0.3 runs", "one hot group", "singleton groups", "overflow", "none", "guard", "edges",
)


@pytest.mark.parametrize("layout", REFRESH_LAYOUTS)
@pytest.mark.parametrize("m,f,fc", [(8192, 2048, 256), (2048, 2048, 512), (2048, 264, 256), (300, 100, 16)])
def test_refresh_kernel_matches_plain(cuda, m, f, fc, layout) -> None:
    r"""Every refresh layout at the step's width with tiles of 256 and 512
    cells and at 264 and 100 bits (scalar loads, byte tails): every table
    bit-equal to the plain version's, the guard group unchanged, one call
    (two launches), twice on the same start (the scratch left cleared)."""
    import chip_smoke

    assert chip_smoke.REFRESH_LAYOUTS == REFRESH_LAYOUTS
    case = chip_smoke.refresh_case(np.random.default_rng(59), m, f, fc, layout)
    chip_smoke._refresh_check(chip_smoke.refresh_args(case, cuda), f"M={m} F={f} Fc={fc} {layout}")


@pytest.mark.parametrize("layout", ["t=0.3 runs", "overflow", "edges"])
def test_refresh_kernel_in_any_order(cuda, layout) -> None:
    r"""The order sets only the runs the kernel adds in registers: rows in
    row order and in a random order give the plain version's tables."""
    import chip_smoke

    rng = np.random.default_rng(60)
    case = chip_smoke.refresh_case(rng, 2048, 2048, 256, layout)
    args = chip_smoke.refresh_args(case, cuda)
    for order in (np.arange(2048), rng.permutation(2048)):
        got = args[:-1] + (torch.from_numpy(order).to(cuda),)
        chip_smoke._refresh_check(got, f"order {layout}")


def test_refresh_kernel_on_a_mid_fit_step(cuda) -> None:
    r"""The 1M configuration's fit (t = 0.3, batch 8,192, phase 4's
    capacities) over its first 262,144 rows: sampled refresh calls held
    bit-equal to the plain version, and the 20th step's call again on its
    own inputs."""
    import chip_smoke
    from bblean_tpu_torch.ops import refresh as rf

    fps = make_fake_fingerprints(1 << 18, 2048, seed=SEED)
    with chip_smoke._RefreshWork(rf.refresh_touched_plain, keep_at=20) as work:
        tree = BatchTree(
            2048, threshold=0.3, batch_size=8192, device="cuda", **chip_smoke.FIT_SETTINGS[0.3],
        )
        tree.fit_packed(torch.from_numpy(fps).to(cuda), range(1 << 18))
        torch.cuda.synchronize()
    assert work.calls >= 32 and work.checked >= 4 and work.kept is not None
    chip_smoke._refresh_check(work.kept, "the 20th step of the 1M configuration's fit")


def test_refresh_launches_twice_without_a_sync_or_an_allocation(cuda) -> None:
    r"""A call is two launches (the fold, the votes) and nothing else on
    the card: no copy, no fill, no host read (sync debug mode raises on
    one), no allocation once its scratch exists."""
    import chip_smoke
    from bblean_tpu_torch.ops import refresh as rf
    from torch.profiler import ProfilerActivity, profile

    case = chip_smoke.refresh_case(np.random.default_rng(61), 8192, 2048, 256, "t=0.3 runs")
    args = chip_smoke.refresh_args(case, cuda)
    rf.refresh_touched(*args)  # makes the scratch
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(3):
                rf.refresh_touched(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() == allocated
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(names) == 6, names
    assert all(any(k in n for k in chip_smoke.REFRESH_KERNELS) for n in names), names


def test_refresh_on_another_stream(cuda) -> None:
    r"""A call on a side stream takes a scratch of its own and gives the
    plain version's tables."""
    import chip_smoke

    case = chip_smoke.refresh_case(np.random.default_rng(62), 2048, 2048, 256, "one hot group")
    args = chip_smoke.refresh_args(case, cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        chip_smoke._refresh_check(args, "a side stream")


def test_refresh_wrapper_rejects_bad_inputs(cuda) -> None:
    import chip_smoke
    from bblean_tpu_torch.ops import refresh as rf

    case = chip_smoke.refresh_case(np.random.default_rng(63), 64, 64, 256, "t=0.3 runs")
    args = chip_smoke.refresh_args(case, cuda)
    at = {name: i for i, name in enumerate(chip_smoke.REFRESH_ARGS)}
    bad = {
        at["g_ls"]: args[at["g_ls"]].to(torch.int64),  # the sums' dtype
        at["t_pk"]: args[at["t_pk"]][..., :-1],  # the tiles' bytes
        at["g_cent"]: args[at["g_cent"]].to(torch.uint8),  # the centroids' dtype
        at["n"]: args[at["n"]][:-1],  # the counts' length
        at["row_ls"]: args[at["row_ls"]].t().contiguous().t(),  # not contiguous
        at["row_pk"]: args[at["row_pk"]][:, :-1],  # the packed rows' bytes
        at["row_single"]: args[at["row_single"]].to(torch.uint8),  # the flag's dtype
        at["order"]: args[at["order"]].to(torch.int32),  # the order's dtype
        at["assigned"]: args[at["assigned"]].cpu(),  # another device
    }
    for i, t in bad.items():
        with pytest.raises(ValueError):
            rf.refresh_touched(*args[:i], t, *args[i + 1:])
    for i in (at["row_pk"], at["row_single"], at["order"]):
        with pytest.raises(ValueError, match="needed on the card"):
            rf.refresh_touched(*args[:i], None, *args[i + 1:])
