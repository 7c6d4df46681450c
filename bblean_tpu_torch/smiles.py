r"""Line-streaming SMILES file IO.

A copy of ``bblean_tpu/smiles.py``: ``load_smiles``, ``calc_num_smiles``,
``iter_smiles_from_paths`` and the batch iterators that the featurization
workers of ``cli.py``'s ``fps-from-smiles`` use.
"""

from __future__ import annotations

import typing as tp
from pathlib import Path

__all__ = ["load_smiles", "calc_num_smiles", "iter_smiles_from_paths"]


def load_smiles(path: Path | str) -> list[str]:
    r"""All SMILES strings of a ``.smi`` file (one per non-empty line)."""
    return list(iter_smiles_from_paths([Path(path)]))


def calc_num_smiles(paths: tp.Iterable[Path | str]) -> int:
    r"""Total SMILES count over files (full pass; lines are not stored)."""
    return sum(1 for _ in iter_smiles_from_paths(paths))


def iter_smiles_from_paths(
    paths: tp.Iterable[Path | str],
) -> tp.Iterator[str]:
    r"""Stream SMILES from files, skipping blank lines.

    Only the first whitespace-delimited token of each line is yielded
    (``.smi`` files may carry names/ids after the SMILES).
    """
    for path in paths:
        with open(path, "rt", encoding="utf-8") as f:
            for line in f:
                token = line.split(maxsplit=1)
                if token:
                    yield token[0]


def _iter_ranges_and_smiles_batches(
    paths: tp.Sequence[Path], batch_size: int
) -> tp.Iterator[tuple[tuple[int, int], list[str]]]:
    r"""Yield ((start, end), batch) index ranges over concatenated files."""
    start = 0
    batch: list[str] = []
    for smi in iter_smiles_from_paths(paths):
        batch.append(smi)
        if len(batch) == batch_size:
            yield (start, start + len(batch)), batch
            start += len(batch)
            batch = []
    if batch:
        yield (start, start + len(batch)), batch


def _iter_idxs_and_smiles_batches(
    paths: tp.Sequence[Path], batch_size: int
) -> tp.Iterator[tuple[int, list[str]]]:
    r"""Yield (batch_idx, batch) pairs over concatenated files."""
    for i, (_range, batch) in enumerate(
        _iter_ranges_and_smiles_batches(paths, batch_size)
    ):
        yield i, batch
