r"""The refine as the benchmark runs it (cell ``refine-1m-t030``), on the CPU at
a small size: ``BatchTree.refine_inplace`` with the command line's refine
settings, its spans and counters, the plain reference that judges a
refined clustering (``perfbench/reference_refine.py``) against sound and
broken refines, the driver ``perfbench/drivers/refined_fits.py`` end to
end, and the five readers of the refine's per-layer metrics.

The library is ``perfbench/library.py``'s generator at 256 bits (the
popcount's law scaled from 2048 bits), 4,096 rows at t = 0.30 and batch
256: the tree's steps cost a fraction of what 2048-bit rows cost here, and
the refine explodes ten clusters of 55-714 rows (1,618 rows) and
re-inserts 1,873 buffers in eight batches."""

from __future__ import annotations

import functools
import json
import shutil
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bblean_tpu_torch import BatchTree  # noqa: E402
from bblean_tpu_torch.engine import batch as tb, spans  # noqa: E402
from perfbench import manifest, reference_refine, trace  # noqa: E402
from perfbench.library import make_library  # noqa: E402
from perfbench.observe import Observation  # noqa: E402

torch.set_num_threads(2)

SEED = 2**31 + 4099
N, F = 4096, 256
LIBRARY = dict(popcount_loc=93, popcount_scale=50, popcount_min=1, popcount_max=255)
REFINE = dict(n_largest=10, threshold=0.3, merge_criterion="tolerance-diameter", tolerance=0.05)
LIMITS = json.loads((ROOT / "perfbench/traffic/refined-fits.json").read_text())["reference"][
    "lib1m-t030"
]["limits"]
# The refined share of rows merged by the program on SEED at this size, at
# batch 256 and 1024 (the driver's cell runs batch 256)
SHARE = {256: 0.54833984375, 1024: 0.45947265625}
# The same, of the driver's cell cut to 2,048 rows at batch 256
DRIVER_SHARE = 0.52978515625
READERS = ("refine.extract_ms", "refine.buffers_ms", "refine.rows_ms", "refine.h2d_ms",
           "refine.device_idle")


@functools.lru_cache(maxsize=None)
def _library() -> np.ndarray:
    return make_library(N, F, SEED, chunk_rows=N, device="cpu", **LIBRARY).numpy()


def _tree(batch: int, cls: type = BatchTree) -> BatchTree:
    return cls(F, threshold=0.3, batch_size=batch, initial_capacity=N + batch + 1, device="cpu")


def _refine(batch: int = 256, cls: type = BatchTree, **kw) -> tuple[BatchTree, np.ndarray]:
    r"""(the refined tree, the clustering before the refine) of one job."""
    lib = _library()
    tree = _tree(batch, cls)
    tree.fit_packed(lib, range(N))
    before = tree.assignments()
    tree.refine_inplace(lib, **{**REFINE, **kw})
    return tree, before


def _check(tree: BatchTree, before: np.ndarray, share: float) -> dict[str, float]:
    return reference_refine.check_refine(
        torch.from_numpy(_library()), before, tree.assignments(), tree.cluster_sizes(),
        {t: getattr(tree.state, t) for t in reference_refine.TABLES}, 0.3, share, 10,
    )


def _sound(readings: dict[str, float]) -> bool:
    return all(readings[k] <= LIMITS[k] for k in reference_refine.NAMES)


def _broken(kind: str) -> type:
    class Broken(BatchTree):
        def refine_inplace(self, X, *args, **kwargs):
            self._lib = X
            if kind == "eleventh exploded":
                kwargs["n_largest"] += 1
            return super().refine_inplace(X, *args, **kwargs)

        def _insert_survivors(self, surv):
            if kind != "survivor split":
                return super()._insert_survivors(surv)
            # The largest survivor's last row leaves its buffer row (a pool
            # row on the device) and enters on its own at a threshold no
            # merge passes: counts, sums and centroids stay exact, and the
            # survivor lies in two clusters
            mol = int(surv.mols[surv.bounds[1] - 1])
            bits = np.unpackbits(self._lib[mol]).astype(np.int64)
            assert int(surv.ref[0]) >= 0
            surv.ls[surv.ref[0]] -= torch.from_numpy(bits).to(surv.ls)
            surv.n[0] -= 1
            surv.sizes[0] -= 1
            surv.mols = np.delete(surv.mols, surv.bounds[1] - 1)
            surv.bounds[1:] -= 1
            super()._insert_survivors(surv)
            threshold, self.threshold = self.threshold, 2.0
            super().insert_buffers(np.concatenate([bits, [1]])[None], [[mol]])
            self.threshold = threshold

        def fit_packed(self, packed_fps, mol_indices):
            if kind == "exploded row dropped" and hasattr(self, "_lib"):
                return super().fit_packed(packed_fps[:-1], list(mol_indices)[:-1])
            return super().fit_packed(packed_fps, mol_indices)

    return Broken


@pytest.fixture(autouse=True)
def _recording_off():
    spans.on = False
    spans.take()
    yield
    spans.on = False
    spans.take()


# ---- the reference ----


@pytest.mark.parametrize("batch", [256, 1024])
def test_a_sound_refine_reads_zero(batch):
    tree, before = _refine(batch)
    got = _check(tree, before, SHARE[batch])
    assert _sound(got), got
    assert got["survivor_split"] == 0 and got["merge_share_gap"] == 0.0
    assert all(got[k] == 0 for k in ("rows_not_once", "count_mismatch", "sum_mismatch",
                                     "centroid_mismatch"))


@pytest.mark.parametrize(
    "kind, number",
    [
        ("survivor split", "survivor_split"),
        ("exploded row dropped", "rows_not_once"),
        ("eleventh exploded", "survivor_split"),
    ],
)
def test_a_planted_fault_reads_above_its_limit(kind, number):
    tree, before = _refine(cls=_broken(kind))
    got = _check(tree, before, SHARE[256])
    assert got[number] > LIMITS[number], got
    if kind != "exploded row dropped":  # the tables stay exact: only the split shows
        assert all(got[k] == 0 for k in ("rows_not_once", "count_mismatch", "sum_mismatch",
                                         "centroid_mismatch"))


def test_a_refine_under_the_diameter_criterion_is_a_blind_spot_here():
    # Structurally sound, so the refined share is the one number that could
    # tell it from the command line's tolerance-diameter; it merges more
    # (0.5588 against 0.5483 here), by less than the share's limit at this
    # size (at the cell's 1M rows by more: PERF.md)
    tree, before = _refine(merge_criterion="diameter")
    got = _check(tree, before, SHARE[256])
    assert got["survivor_split"] == 0 and got["criterion_gap"] <= LIMITS["criterion_gap"]
    assert 0 < got["merge_share_gap"] <= LIMITS["merge_share_gap"]
    assert tree.num_clusters < round(N * (1 - SHARE[256]))


@pytest.mark.parametrize(
    "before, after, k, split",
    [
        ([0, 0, 0, 1, 1, 2], [0, 1, 2, 3, 3, 4], 1, 0),  # the largest split in three
        ([0, 0, 0, 1, 1, 2], [0, 1, 2, 3, 4, 5], 1, 1),  # and a survivor of two
        ([0, 0, 1, 1, 2, 3], [0, 1, 2, 3, 4, 5], 1, 1),  # a tie at the k-th size: one of two
        ([0, 0, 1, 1, 2, 3], [0, 1, 2, 3, 4, 5], 2, 0),
        ([0, 0, 0, 1, 1, 2], [5, 5, 5, 3, 3, 4], 1, 0),  # the exploded cluster formed again
        ([0, 0, 1, 1], [0, 0, 1], 1, 0),  # a row without a cluster is rows_not_once's
        ([0, 0, 1, 1], [0, 1, 2, 2], 0, 1),  # nothing exploded
    ],
)
def test_survivor_split_counts_splits_beyond_the_exploded(before, after, k, split):
    assert reference_refine.survivor_split(np.array(before), np.array(after), k) == split


# ---- the port's spans and counters ----


def test_the_spans_of_a_refine_nest_under_its_root():
    lib = _library()
    tree = _tree(256)
    tree.fit_packed(lib, range(N))
    n_buffers = tree.num_clusters - 10
    spans.on = True
    tree.refine_inplace(lib, **REFINE)
    spans.on = False
    records = spans.take()
    by_id = {r.id: r for r in records}
    (root,) = [r for r in records if r.parent == 0]
    assert root.name == "refine" and all(r.root == root.id for r in records)
    for r in records:
        if r is not root:
            p = by_id[r.parent]
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns, (r, p)
    children = sorted((r for r in records if r.parent == root.id), key=lambda r: r.start_ns)
    assert [r.name for r in children] == ["refine.extract", "buffers", "refine.load", "fit"]
    (buffers,) = [r for r in children if r.name == "buffers"]
    stages = [r for r in records if r.name == "buffers.stage"]
    assert len(stages) == -(-n_buffers // 256)  # one a batch
    assert all(r.parent == buffers.id for r in stages)
    assert {"step", "sync", "boundary", "split"} <= {r.name for r in records}


def test_a_plain_fit_records_no_refine_span():
    spans.on = True
    _tree(256).fit_packed(_library()[:1024], range(1024))
    spans.on = False
    records = spans.take()
    (root,) = [r for r in records if r.parent == 0]
    assert root.name == "fit" and all(r.root == root.id for r in records)
    assert not {"refine", "refine.extract", "refine.load", "buffers", "buffers.stage"} & {
        r.name for r in records
    }


def test_the_refine_counters_rise_by_its_work():
    names = ("refine_calls", "refine_buffer_rows", "refine_exploded_rows", "refine_extract_ns",
             "refine_buffers_ns", "refine_rows_ns")
    lib = _library()
    tree = _tree(256)
    tree.fit_packed(lib, range(N))
    sizes = np.sort(tree.cluster_sizes())[::-1]
    start = {k: getattr(tb, k) for k in names}
    t0 = time.perf_counter_ns()
    tree.refine_inplace(lib, **REFINE)
    wall = time.perf_counter_ns() - t0
    rise = {k: getattr(tb, k) - start[k] for k in names}
    assert rise["refine_calls"] == 1
    assert rise["refine_buffer_rows"] == len(sizes) - 10
    assert rise["refine_exploded_rows"] == sizes[:10].sum()
    stages = rise["refine_extract_ns"] + rise["refine_buffers_ns"] + rise["refine_rows_ns"]
    assert min(rise[k] for k in names[3:]) > 0 and 0.9 * wall <= stages <= wall


def test_the_device_buffer_rows_count_the_handoff_only():
    r"""``refine_device_buffer_rows`` rises by what ``refine_buffer_rows``
    rises in a refine, by the clusters re-inserted in a recluster, and not
    at all for a user's ``insert_buffers``."""
    lib = _library()[:1024]
    tree = _tree(256)
    tree.fit_packed(lib, range(len(lib)))
    start = (tb.refine_device_buffer_rows, tb.refine_buffer_rows)
    tree.refine_inplace(lib, **REFINE)
    rise = tb.refine_device_buffer_rows - start[0]
    assert rise > 256 and rise == tb.refine_buffer_rows - start[1]
    n_clusters = tree.num_clusters
    start = (tb.refine_device_buffer_rows, tb.refine_buffer_rows)
    tree.recluster_inplace()
    assert tb.refine_device_buffer_rows - start[0] == n_clusters
    assert tb.refine_buffer_rows == start[1]
    sums = np.unpackbits(lib[:300], axis=-1).astype(np.int64)
    user = _tree(256)
    start = tb.refine_device_buffer_rows
    user.insert_buffers(np.concatenate([sums, np.ones((300, 1), np.int64)], axis=1),
                        [[i] for i in range(300)])
    assert tb.refine_device_buffer_rows == start and user.num_clusters > 0


# ---- the driver and the readers ----


@pytest.fixture
def tiny_root(tmp_path: Path) -> Path:
    r"""A copy of the benchmark with ``lib1m-t030`` cut to half this
    file's library (2,048 rows)."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(
        ROOT / "perfbench", tmp_path / "perfbench",
        ignore=shutil.ignore_patterns("__pycache__", "tests"),
    )
    path = tmp_path / "perfbench/configs/lib1m-t030.json"
    cfg = json.loads(path.read_text())
    cfg.update(n_rows=N // 2, n_features=F)
    cfg["batch_tree"].update(batch_size=256, initial_capacity=N // 2 + 257)
    path.write_text(json.dumps(cfg))
    path = tmp_path / "perfbench/traffic/refined-fits.json"
    traffic = json.loads(path.read_text())
    traffic["library"].update(chunk_rows=N, **LIBRARY)
    traffic["warm_prefix_rows"] = 512
    traffic["reference"]["lib1m-t030"]["merge_share"] = DRIVER_SHARE
    path.write_text(json.dumps(traffic))
    return tmp_path


def _with_device_events(real):
    r"""``trace.events`` with one kernel and one host-to-device copy put
    inside the profiled refine (the CPU's profile holds no device event)."""

    def events(prof):
        device, host = real(prof)
        (lo, hi), = [(s, e) for name, s, e in host if name == "perfbench.traced_fit"]
        mid = (lo + hi) // 2
        device += [("memcpy", "Memcpy HtoD (Pageable -> Device)", lo, lo + 1000),
                   ("kernel", "void k()", mid, mid + 1000)]
        return device, host

    return events


def test_the_driver_runs_the_cell_and_every_reader_reads(tiny_root, monkeypatch):
    from perfbench.run import run_cell

    monkeypatch.setattr(trace, "events", _with_device_events(trace.events))
    result, lines = run_cell(
        tiny_root, "refine-1m-t030", seed=SEED, seconds=0, trace=True, device="cpu",
        t_start=time.perf_counter(),
    )
    assert result["correct"] and result["failed"] == 0 and result["attempted"] == 2, lines
    assert set(result["metrics"]) == set(READERS)
    assert all(m["value"] is not None and m["value"] > 0 for m in result["metrics"].values())
    assert result["compared"]["survivor_split"]["value"] == 0
    assert list(result)[-1] == "compared"


def test_a_broken_refine_through_the_driver_is_not_correct(tiny_root):
    from perfbench.run import run_cell

    result, _lines = run_cell(
        tiny_root, "refine-1m-t030", seed=SEED, seconds=0, trace=False, device="cpu",
        t_start=time.perf_counter(), tree_cls=_broken("survivor split"),
    )
    assert not result["correct"] and result["failed"] == 1
    assert set(result["metrics"]) == {"fit_rate", "setup_s"}  # no card: no peak memory
    got = result["compared"]["survivor_split"]
    assert got["value"] > got["limit"]


@pytest.mark.parametrize("criterion", ["diameter", "tolerance-diameter"])
def test_the_refine_control_is_the_merge_test_in_bfloat16(criterion):
    from bblean_tpu_torch.ops.isim import isim_from_sums
    from bblean_tpu_torch.ops.merges import _adaptive_tol, merge_accept_batch, merge_moments
    from perfbench.control_refine import bfloat16_merge_test

    gen = torch.Generator().manual_seed(7)
    rows = 4096
    old_n = torch.randint(1, 40, (rows,), generator=gen, dtype=torch.int32)
    p = (torch.rand((rows, 1), generator=gen) * 0.5 + 0.25).expand(rows, F)
    old_ls = torch.binomial(old_n[:, None].float().expand(rows, F), p, generator=gen).int()
    new_ls, new_n = old_ls + (torch.rand((rows, F), generator=gen) < p).int(), old_n + 1
    moments = merge_moments(criterion, new_ls, new_n, old_ls, old_n)
    real = merge_accept_batch(criterion, 0.3, new_ls, new_n, old_ls, old_n, new_n, 0.05)
    bf16 = bfloat16_merge_test(criterion, 0.3, moments, new_n, old_n, new_n, 0.05)
    # They differ, and only where bfloat16's rounding crosses one of the
    # test's two edges
    new_c = isim_from_sums(new_ls, new_n)
    old_c = torch.where(old_n < 2, 0.0, isim_from_sums(old_ls, old_n.clamp_min(2)))
    edge = (new_c - 0.3).abs() < 4e-3
    if criterion == "tolerance-diameter":
        edge |= (new_c - old_c + _adaptive_tol(0.05, old_n)).abs() < 4e-3
    differ = real != bf16
    assert differ.any() and not (differ & ~edge).any()
    with pytest.raises(ValueError):
        bfloat16_merge_test("radius", 0.3, moments, new_n, old_n, new_n, 0.05)


def test_the_readers_find_nothing_without_the_counters_or_a_trace():
    man = manifest.load(ROOT)
    obs = Observation(rows=N, deltas={})
    for name in READERS:
        assert man.metric(name).read(obs) is None
    # A program without the counters: the driver leaves them out of deltas
    driver = man.driver("refined_fits")
    assert driver._counters(["bblean_tpu_torch.engine.batch:no_such_counter"]) == {}
    assert driver._counters(["bblean_tpu_torch.engine.batch:refine_calls"]) == {
        "bblean_tpu_torch.engine.batch:refine_calls": tb.refine_calls
    }


def test_the_cells_and_metrics_are_in_the_manifest():
    man = manifest.load(ROOT)
    assert man.workloads["refine-1m-t030"]["config"] == "lib1m-t030"
    assert man.workloads["fit-1m-t065"]["config"] == "lib1m-t065"
    assert {m["name"] for m in man.per_layer_of("refine-1m-t030")} == set(READERS)
    for name in READERS:
        assert man.per_layer[name]["workloads"] == ["refine-1m-t030"]
