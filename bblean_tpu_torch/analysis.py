r"""Post-clustering analysis: size statistics, per-cluster iSIM, scaffolds.

A copy of ``bblean_tpu/analysis.py`` on the port's host modules: iSIM from
``similarity.py``, the fingerprint files and packing from
``fingerprints.py``.  It runs on the host in NumPy.  pandas is imported
only by ``ClusterAnalysis.stats`` and RDKit only by ``scaffold_analysis``,
so the module imports where neither is installed.
"""

from __future__ import annotations

import csv
import dataclasses
import typing as tp
from functools import cached_property
from pathlib import Path

import numpy as np
from numpy.typing import NDArray

from bblean_tpu_torch._config import DEFAULTS
from bblean_tpu_torch.fingerprints import (
    _FingerprintFileSequence,
    fps_from_smiles,
    pack_fingerprints,
    unpack_fingerprints,
)
from bblean_tpu_torch.similarity import jt_isim

__all__ = [
    "scaffold_analysis",
    "cluster_analysis",
    "ScaffoldAnalysis",
    "ClusterAnalysis",
]


@dataclasses.dataclass
class ScaffoldAnalysis:
    r"""Scaffold diversity summary of one molecule set."""

    unique_num: int
    isim: float


@dataclasses.dataclass
class _ClusterRecord:
    r"""Everything computed for one selected (top-k) cluster."""

    label: int  # 1-based rank by size
    size: int
    isim: float | None = None
    scaffold_num: int | None = None
    scaffold_isim: float | None = None
    fps: NDArray[np.uint8] | None = None  # this cluster's rows, as given


class ClusterAnalysis:
    r"""Result object: whole-population size stats + per-top-cluster details.

    Size statistics cover *every* cluster; iSIM / scaffold / fingerprint
    details exist only for the selected (top-k, min-size-filtered) ones.
    """

    def __init__(
        self,
        records: list[_ClusterRecord],
        all_sizes: NDArray[np.int64],
        total_fps_num: int,
        fps_are_packed: bool = True,
        n_features: int | None = None,
        min_size: int | None = None,
    ) -> None:
        self._records = records
        self._all_sizes = np.asarray(all_sizes, dtype=np.int64)
        self.total_fps = total_fps_num
        self.fps_are_packed = fps_are_packed
        self.n_features = n_features
        self.min_size = min_size

    # -- whole-population size statistics (numpy, not pandas) --

    def _quantile(self, q: float) -> float:
        if self._all_sizes.size == 0:
            return float("nan")
        return float(np.percentile(self._all_sizes, q * 100.0))

    @cached_property
    def stats(self):
        r"""``pandas.Series.describe()``-shaped view of the size stats."""
        import pandas as pd

        return pd.Series(self._all_sizes).describe()

    @property
    def all_clusters_num(self) -> int:
        return int(self._all_sizes.size)

    @property
    def all_clusters_mean_size(self) -> float:
        return float(self._all_sizes.mean()) if self._all_sizes.size else float("nan")

    @property
    def all_clusters_median_size(self) -> int:
        return int(self._quantile(0.5))

    @property
    def all_clusters_q1(self) -> int:
        return int(self._quantile(0.25))

    @property
    def all_clusters_q3(self) -> int:
        return int(self._quantile(0.75))

    @property
    def all_clusters_min_size(self) -> int:
        return int(self._all_sizes.min())

    @property
    def all_clusters_max_size(self) -> int:
        return int(self._all_sizes.max())

    @cached_property
    def all_singletons_num(self) -> int:
        return int((self._all_sizes == 1).sum())

    def all_clusters_num_with_size_above(self, size: int) -> int:
        return int((self._all_sizes > size).sum())

    # -- selected-cluster details --

    @property
    def clusters_num(self) -> int:
        return len(self._records)

    @property
    def labels(self) -> list[int]:
        return [r.label for r in self._records]

    @property
    def sizes(self) -> list[int]:
        return [r.size for r in self._records]

    @property
    def isims(self) -> list[float]:
        return [tp.cast(float, r.isim) for r in self._records]

    @property
    def unique_scaffolds_num(self) -> list[int]:
        return [tp.cast(int, r.scaffold_num) for r in self._records]

    @property
    def unique_scaffolds_isim(self) -> list[float]:
        return [tp.cast(float, r.scaffold_isim) for r in self._records]

    @property
    def has_fps(self) -> bool:
        return any(r.fps is not None for r in self._records)

    @property
    def has_scaffolds(self) -> bool:
        return any(r.scaffold_num is not None for r in self._records)

    @property
    def has_all_clusters(self) -> bool:
        return self.clusters_num == self.all_clusters_num

    def get_top_cluster_fps(self, packed: bool = True) -> list[NDArray[np.uint8]]:
        r"""Per-selected-cluster fingerprint arrays, packed or unpacked."""
        if not self.has_fps:
            raise RuntimeError("Fingerprints not present")
        out = []
        for r in self._records:
            assert r.fps is not None
            out.append(self._convert(r.fps, packed))
        return out

    def _convert(self, arr: NDArray[np.uint8], packed: bool) -> NDArray[np.uint8]:
        if packed == self.fps_are_packed:
            return arr
        if packed:
            return pack_fingerprints(arr)
        return unpack_fingerprints(arr, self.n_features)

    @property
    def top_packed_fps(self) -> NDArray[np.uint8]:
        return np.concatenate(self.get_top_cluster_fps(packed=True), axis=0)

    @property
    def top_unpacked_fps(self) -> NDArray[np.uint8]:
        return np.concatenate(self.get_top_cluster_fps(packed=False), axis=0)

    # -- export --

    def _columns(self) -> dict[str, list]:
        cols: dict[str, list] = {"labels": self.labels, "sizes": self.sizes}
        if self.has_scaffolds:
            cols["unique_scaffolds_num"] = self.unique_scaffolds_num
            cols["unique_scaffolds_isim"] = self.unique_scaffolds_isim
        if self.has_fps:
            cols["isim"] = self.isims
        return cols

    def dump_metrics(self, path: Path) -> None:
        cols = self._columns()
        with open(path, "w", newline="") as f:
            writer = csv.writer(f)
            writer.writerow(cols.keys())
            writer.writerows(zip(*cols.values()))


def scaffold_analysis(
    smiles: tp.Iterable[str], fp_kind: str = DEFAULTS.fp_kind
) -> ScaffoldAnalysis:
    r"""Murcko-scaffold diversity of a molecule set (order-independent).

    Requires RDKit. Parity: reference ``bblean/analysis.py:166-179``.
    """
    from rdkit.Chem.Scaffolds import MurckoScaffold

    if isinstance(smiles, str):
        smiles = [smiles]
    scaffolds = {
        MurckoScaffold.MurckoScaffoldSmilesFromSmiles(smi) for smi in smiles
    }
    scaffold_fps = fps_from_smiles(scaffolds, kind=fp_kind, pack=False)
    return ScaffoldAnalysis(
        len(scaffolds), jt_isim(scaffold_fps, input_is_packed=False)
    )


def _open_fps_source(
    fps: NDArray[np.integer] | Path | tp.Sequence[Path] | None,
):
    r"""Normalize the ``fps`` argument to something row-indexable (or None)."""
    if fps is None:
        return None
    if isinstance(fps, np.ndarray):
        return fps.astype(np.uint8, copy=False)
    if isinstance(fps, Path):
        return np.load(fps, mmap_mode="r")
    return _FingerprintFileSequence(fps)


def _select_top(
    clusters: list[list[int]], top: int | None, min_size: int
) -> list[list[int]]:
    r"""Prefix of size-sorted clusters: at most ``top``, stopping at the
    first cluster below ``min_size`` (input assumed largest-first)."""
    limit = len(clusters) if top is None else min(top, len(clusters))
    kept: list[list[int]] = []
    for members in clusters[:limit]:
        if len(members) < min_size:
            break
        kept.append(members)
    return kept


def cluster_analysis(
    clusters: list[list[int]],
    fps: NDArray[np.integer] | Path | tp.Sequence[Path] | None = None,
    smiles: tp.Iterable[str] = (),
    n_features: int | None = None,
    top: int | None = 20,
    assume_sorted: bool = True,
    scaffold_fp_kind: str = DEFAULTS.fp_kind,
    input_is_packed: bool = True,
    min_size: int = 0,
) -> ClusterAnalysis:
    r"""Analyze clusters: sizes, per-cluster iSIM, optional scaffold stats.

    ``fps`` may be an in-memory array, one ``.npy`` path (mmap-loaded), or a
    sequence of paths treated as one concatenated file sequence.
    Parity: reference ``bblean/analysis.py:182-258``.
    """
    if isinstance(smiles, str):
        smiles = [smiles]
    smiles_arr = np.asarray(list(smiles))

    if not assume_sorted:
        clusters = sorted(clusters, key=len, reverse=True)
    all_sizes = np.fromiter((len(c) for c in clusters), dtype=np.int64)

    source = _open_fps_source(fps)
    records = []
    for rank, members in enumerate(_select_top(clusters, top, min_size), 1):
        rec = _ClusterRecord(label=rank, size=len(members))
        if smiles_arr.size:
            scaf = scaffold_analysis(
                smiles_arr[members], fp_kind=scaffold_fp_kind
            )
            rec.scaffold_num = scaf.unique_num
            rec.scaffold_isim = scaf.isim
        if source is not None:
            # File sequences require sorted indices; iSIM and the stats are
            # row-order-independent so sorting is always safe.
            rows = np.ascontiguousarray(source[sorted(members)], dtype=np.uint8)
            rec.isim = jt_isim(
                rows, input_is_packed=input_is_packed, n_features=n_features
            )
            rec.fps = rows
        records.append(rec)

    return ClusterAnalysis(
        records,
        all_sizes,
        total_fps_num=int(all_sizes.sum()),
        fps_are_packed=input_is_packed,
        n_features=n_features,
        min_size=min_size,
    )
