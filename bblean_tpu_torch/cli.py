r"""Command-line interface of the PyTorch + CUDA port.

Every command of ``bblean_tpu/cli.py``, under the same command and option
names and defaults: clustering on the host with ``BitBirch``
(``run``, whose default is ``--engine exact``: reference-identical labels),
with the batched engine on the device (``run --engine batch``) or sharded
over every visible device (``run --engine sharded``), the multi-process
workflow over many files (``multiround``), and fingerprint file management
(``fps-info``, ``fps-split``, ``fps-shuffle``, ``fps-merge``).  Run-dir
conventions are identical: a random 8-hex-digit directory under
``bb_run_outputs/`` containing ``clusters.pkl``,
``cluster-centroids-packed.pkl``, ``config.json``, ``timings.json``,
``monitor-rss.csv`` / ``max-rss.txt`` and ``input-fps/`` symlinks.

``--engine exact`` and ``multiround`` run on the host: in the native C++
engine, built with ``$CXX`` or ``g++`` at first use, or in the Python
engine where there is no compiler or ``BBLEAN_TPU_NO_EXTENSIONS=1`` is set.
The labels are the same; ``config.json`` names the one that ran
(``host_engine``).

The rest of ``bb``'s commands are here too: SMILES featurization
(``fps-from-smiles``: serial, one file per batch through a ``forkserver``
pool, or ``-p N --single-file`` into shared memory; it needs RDKit) and
the analysis of a run directory (``summary``; ``plot-summary``,
``plot-pops``, ``plot-pca``, ``plot-tsne``, ``plot-umap``, which need
matplotlib, and seaborn or umap-learn for two of them), and
``--version``.  A command whose optional package is missing exits with
code 1 and an error that names the package.

One option is the port's own: ``--device`` (default ``cuda``) of ``run``
and ``plot-tsne``.  A batch or sharded run, or the t-SNE of ``plot-tsne``
(where openTSNE is not installed), without a CUDA device raises unless
``--device cpu`` asks for the plain PyTorch path (``--engine sharded
--device cpu`` runs one CPU shard).  The exact engine uses no device and
ignores the option.

Parsed with ``argparse``.  :func:`main` takes the argument list (default
``sys.argv[1:]``); a usage error exits with code 2, and a :class:`CliError`
or a missing package (``ImportError``) with code 1, as a command-line
program does.
"""

from __future__ import annotations

import argparse
import pickle
import random
import shutil
import sys
import time
import typing as tp
import warnings
from pathlib import Path

import numpy as np

from bblean_tpu_torch._config import DEFAULTS, collect_system_specs_and_dump_config
from bblean_tpu_torch._console import get_console
from bblean_tpu_torch._timer import Timer

__all__ = ["main", "CliError"]

PROG = "bb-torch"
DISTRIBUTION = "bblean-tpu"


class CliError(Exception):
    r"""A failure to report as ``Error: <message>`` with exit code 1."""


# -- helpers ------------------------------------------------------------------


def _discover_input_files(input_: Path | None) -> list[Path]:
    if input_ is None:
        input_ = Path.cwd() / "bb_inputs"
        input_.mkdir(exist_ok=True)
    if input_.is_dir():
        files = sorted(input_.glob("*.npy"))
        if not files:
            raise CliError(f"No *.npy files found in {input_}")
        return files
    return [input_]


def _make_run_dir(out_dir: Path | None, overwrite: bool) -> Path:
    if out_dir is None:
        unique_id = format(random.getrandbits(32), "08x")
        out_dir = Path.cwd() / "bb_run_outputs" / unique_id
    out_dir.mkdir(exist_ok=True, parents=True)
    if not overwrite and any(p.is_file() for p in out_dir.iterdir()):
        raise CliError(f"Output dir {out_dir} has files; pass --overwrite to allow")
    return out_dir


def _dump_cluster_outputs(tree, out_dir: Path, save_centroids: bool) -> None:
    if save_centroids:
        output = tree.get_centroids_mol_ids()
        with open(out_dir / "clusters.pkl", "wb") as f:
            pickle.dump(output["mol_ids"], f)
        with open(out_dir / "cluster-centroids-packed.pkl", "wb") as f:
            pickle.dump(output["centroids"], f)
    else:
        with open(out_dir / "clusters.pkl", "wb") as f:
            pickle.dump(tree.get_cluster_mol_ids(), f)


def _link_input_fps(out_dir: Path, files: tp.Sequence[Path], copy: bool) -> None:
    dest = (out_dir / "input-fps").resolve()
    dest.mkdir(exist_ok=True)
    for f in files:
        target = dest / f.name
        if target.exists() or target.is_symlink():
            continue
        if copy:
            shutil.copy(f, target)
        else:
            target.symlink_to(f.resolve())


# -- clustering commands --------------------------------------------------------


def _run(args: argparse.Namespace) -> None:
    r"""Run BitBIRCH clustering over `*.npy` fingerprint files."""
    from bblean_tpu_torch._device import require_device
    from bblean_tpu_torch._memory import launch_monitor_rss_daemon
    from bblean_tpu_torch.fingerprints import _get_fps_file_num

    # The exact engine runs on the host: it needs no device and names none
    device = None if args.engine == "exact" else require_device(args.device)

    console = get_console(silent=not args.verbose)
    refine_num, refine_rounds = args.refine_num, args.refine_rounds
    if refine_rounds is None:
        refine_rounds = 1 if refine_num > 0 else 0
    if refine_rounds > 0 and refine_num == 0:
        refine_num = 1

    input_files = _discover_input_files(args.input_)
    out_dir = _make_run_dir(args.out_dir, args.overwrite)

    config: dict[str, tp.Any] = {
        "command": "run",
        "engine": args.engine,
        **({} if device is None else {"device": str(device)}),
        "input_files": [str(p.resolve()) for p in input_files],
        "num_fps_present": [_get_fps_file_num(p) for p in input_files],
        "out_dir": str(out_dir.resolve()),
        "branching_factor": args.branching_factor,
        "threshold": args.threshold,
        "merge_criterion": args.merge_criterion,
        "tolerance": args.tolerance,
        "refine_num": refine_num,
        "refine_rounds": refine_rounds,
        "recluster_rounds": args.recluster_rounds,
        "refine_merge_criterion": args.refine_merge_criterion,
        "refine_threshold_change": args.refine_threshold_change,
        "n_features": args.n_features,
        "input_is_packed": args.input_is_packed,
        "max_fps": args.max_fps,
    }
    console.print_banner()
    console.print_config(config)

    if args.monitor_rss:
        launch_monitor_rss_daemon(out_dir, args.monitor_rss_interval_s)

    timer = Timer()
    timer.init_timing("total")
    if args.engine == "exact":
        _run_exact_engine(args, input_files, out_dir, config, console, timer,
                          refine_num, refine_rounds)
    else:
        _run_device_engine(args, input_files, out_dir, config, console, timer,
                           refine_num, refine_rounds, device)
    _finish_run(args, config, console, timer, out_dir, input_files)


def _run_device_engine(
    args, input_files, out_dir, config, console, timer, refine_num,
    refine_rounds, device,
) -> None:
    r"""The batch or the sharded engine on ``device``, by ``args.engine``."""
    common = dict(
        device=device,
        threshold=args.threshold, merge_criterion=args.merge_criterion,
        tolerance=args.tolerance, n_features=args.n_features,
        input_is_packed=args.input_is_packed, max_fps=args.max_fps,
        save_centroids=args.save_centroids,
        batch_size=args.engine_batch_size,
        refine_num=refine_num, refine_rounds=refine_rounds,
        refine_merge_criterion=args.refine_merge_criterion,
        refine_threshold_change=args.refine_threshold_change,
        recluster_rounds=args.recluster_rounds,
        recluster_shuffle=args.recluster_shuffle,
    )
    if args.engine == "sharded":
        _run_sharded_engine(input_files, out_dir, config, console, timer, **common)
    else:
        _run_batch_engine(
            input_files, out_dir, config, console, timer,
            fanout=args.engine_fanout, **common,
        )
    timer.end_timing("total", console, indent=False)
    console.print_peak_mem(out_dir)
    console.print_peak_hbm(device)


def _finish_run(args, config, console, timer, out_dir, input_files) -> None:
    collect_system_specs_and_dump_config(config)
    timer.dump(out_dir / "timings.json")
    _link_input_fps(out_dir, input_files, args.copy_inputs)
    console.print(f"Outputs in: {out_dir}")


def _run_exact_engine(
    args, input_files, out_dir, config, console, timer, refine_num, refine_rounds
) -> None:
    r"""``BitBirch`` on the host (native or Python engine): fit every file,
    refine and recluster, then dump the tree's clusters.  ``total`` of
    ``timings.json`` ends before the pickles are written, as in ``bb``."""
    from bblean_tpu_torch.tree import BitBirch

    tree = BitBirch(
        branching_factor=args.branching_factor,
        threshold=args.threshold,
        merge_criterion=args.merge_criterion,
        tolerance=args.tolerance,
    )
    config["host_engine"] = tree.engine_name
    with console.status("[italic]BitBirching...[/italic]", spinner="dots"):
        for file in input_files:
            tree.fit(
                file,
                n_features=args.n_features,
                input_is_packed=args.input_is_packed,
                max_fps=args.max_fps,
            )
    if args.recluster_rounds != 0 or refine_rounds != 0:
        tree.set_merge(
            args.refine_merge_criterion,
            tolerance=args.tolerance,
            threshold=args.threshold + args.refine_threshold_change,
        )
        for r in range(refine_rounds):
            with console.status(
                f"[italic]Refinement, round {r + 1}...[/italic]", spinner="dots"
            ):
                tree.refine_inplace(
                    input_files if len(input_files) > 1 else input_files[0],
                    input_is_packed=args.input_is_packed,
                    n_largest=refine_num,
                )
        for r in range(args.recluster_rounds):
            with console.status(
                f"[italic]Reclustering, round {r + 1}...[/italic]", spinner="dots"
            ):
                tree.recluster_inplace(shuffle=args.recluster_shuffle)
    timer.end_timing("total", console, indent=False)
    console.print_peak_mem(out_dir)
    if args.save_tree:
        tree.save(out_dir / "bitbirch.pkl")
    tree.delete_internal_nodes()
    _dump_cluster_outputs(tree, out_dir, args.save_centroids)


def _run_batch_engine(
    input_files, out_dir, config, console, timer, *, device, threshold,
    merge_criterion, tolerance, n_features, input_is_packed, max_fps,
    save_centroids, batch_size=8192, fanout=None, refine_num=0,
    refine_rounds=0, refine_merge_criterion=None,
    refine_threshold_change=0.0, recluster_rounds=0,
    recluster_shuffle=False,
) -> None:
    r"""The batched engine over ``device``.

    Besides ``total``, ``timings.json`` gets the wall of each part: ``fit``
    (``fit_packed`` of every file: reading the mapped rows and staging them
    onto the device included), ``refine``, ``recluster``, ``extract_mols``
    (sizes and molecule lists off the device, sorted by size),
    ``pickle_clusters``, ``extract_centroids`` (linear sums off the device,
    majority vote, sorted) and ``pickle_centroids``.
    """
    from bblean_tpu_torch.engine.batch import BatchTree
    from bblean_tpu_torch.fingerprints import _get_fps_file_num, pack_fingerprints

    # Pre-size the device tables from the total input row count (read from
    # the .npy headers, nothing loaded), so that a large input does not grow
    # them step by step.  Clusters can never exceed rows.
    total_rows = 0
    for file in input_files:
        n = _get_fps_file_num(file)
        total_rows += min(n, max_fps) if max_fps is not None else n
    capacity = max(8192, total_rows + batch_size + 1)
    tile = None
    if fanout is None:
        # Reference guidance scaled to the tiled layout: larger groups at
        # very large scale keep the routing table (and its matmul) small.
        # An explicit --fanout always wins over this auto-tune.
        fanout, tile = (384, 512) if total_rows > 2_000_000 else (192, None)
        console.print(
            f"Auto-tuned fanout={fanout}"
            + (f", tile={tile}" if tile is not None else "")
            + f" for {total_rows} rows"
        )

    def timed(name: str, since: float) -> float:
        r"""Add the wall since ``since`` to ``name``; returns the clock."""
        if device.type == "cuda":
            import torch

            torch.cuda.synchronize(device)
        now = time.perf_counter()
        timer.timings[name] = timer.timings.get(name, 0.0) + now - since
        return now

    tree: BatchTree | None = None
    offset = 0
    with console.status(f"[italic]BitBirching ({device})...[/italic]", spinner="dots"):
        for file in input_files:
            t0 = time.perf_counter()
            fps = np.load(file, mmap_mode="r")[:max_fps]
            if not input_is_packed:
                fps = pack_fingerprints(np.asarray(fps, dtype=np.uint8))
            if tree is None:
                feats = n_features if n_features is not None else fps.shape[1] * 8
                tree = BatchTree(
                    feats,
                    threshold=threshold,
                    merge_criterion=merge_criterion,
                    tolerance=tolerance,
                    batch_size=batch_size,
                    fanout=fanout,
                    **({"tile": tile} if tile is not None else {}),
                    initial_capacity=capacity,
                    device=device,
                )
            with warnings.catch_warnings():
                # The rows of a read-only mapped file become a tensor that
                # is only read (copied to the device, or sliced on the CPU)
                warnings.filterwarnings(
                    "ignore", message="The given NumPy array is not writable"
                )
                tree.fit_packed(np.asarray(fps), range(offset, offset + len(fps)))
            offset += len(fps)
            timed("fit", t0)
    assert tree is not None
    for r in range(refine_rounds):
        with console.status(
            f"[italic]Refinement, round {r + 1} ({device})...[/italic]",
            spinner="dots",
        ):
            t0 = time.perf_counter()
            tree.refine_inplace(
                input_files if len(input_files) > 1 else input_files[0],
                input_is_packed=input_is_packed,
                n_largest=refine_num,
                threshold=threshold + refine_threshold_change,
                merge_criterion=refine_merge_criterion,
                tolerance=tolerance,
            )
            timed("refine", t0)
    for r in range(recluster_rounds):
        with console.status(
            f"[italic]Reclustering, round {r + 1} ({device})...[/italic]",
            spinner="dots",
        ):
            t0 = time.perf_counter()
            tree.recluster_inplace(shuffle=recluster_shuffle)
            timed("recluster", t0)
    # Sort clusters by size desc (stable), as the exact engine does
    t0 = time.perf_counter()
    sizes = tree.cluster_sizes()
    mols = tree.cluster_mols()
    order = np.argsort(-sizes, kind="stable")
    clusters = [mols[i] for i in order]
    t0 = timed("extract_mols", t0)
    with open(out_dir / "clusters.pkl", "wb") as f:
        pickle.dump(clusters, f)
    t0 = timed("pickle_clusters", t0)
    if save_centroids:
        cents = tree.packed_centroids()
        cents = [cents[i] for i in order]
        t0 = timed("extract_centroids", t0)
        with open(out_dir / "cluster-centroids-packed.pkl", "wb") as f:
            pickle.dump(cents, f)
        timed("pickle_centroids", t0)
    config["n_clusters"] = int(len(sizes))


def _run_sharded_engine(
    input_files, out_dir, config, console, timer, *, device, threshold,
    merge_criterion, tolerance, n_features, input_is_packed, max_fps,
    save_centroids, batch_size=8192, refine_num=0, refine_rounds=0,
    refine_merge_criterion=None, refine_threshold_change=0.0,
    recluster_rounds=0, recluster_shuffle=False,
) -> None:
    r"""The sharded engine: data-parallel over every visible device of the
    kind ``device`` names (one CPU shard with ``--device cpu``).

    The merge-reduction rounds use the refine criterion and threshold-change
    options, mirroring multiround's midsection parameters.  Refinement
    (``--refine-num``) explodes the largest merged clusters into singleton
    rows re-sharded over the mesh and re-fits + re-merges.  ``timings.json``
    gets the parts ``fit`` and ``merge``.
    """
    from bblean_tpu_torch.fingerprints import _get_fps_file_num, pack_fingerprints
    from bblean_tpu_torch.parallel import ShardedForest, get_mesh

    mesh = get_mesh(device=device)
    console.print(f"Sharding over {mesh.size} device(s)")

    total_rows = 0
    for file in input_files:
        n = _get_fps_file_num(file)
        total_rows += min(n, max_fps) if max_fps is not None else n

    # Clamp the batch to the input: every step's tables are batch-shaped,
    # so an 8192-row batch on a 600-row input pays for slots that never
    # hold a row.  One window per shard still covers the whole input.
    if total_rows:
        per_dev = -(-total_rows // mesh.size)
        batch_size = max(64, min(batch_size, 1 << (per_dev - 1).bit_length()))

    forest: ShardedForest | None = None
    timer.init_timing("fit")
    with console.status("[italic]BitBirching (sharded)...[/italic]", spinner="dots"):
        for file in input_files:
            # Files stream through the forest: past the resident budget,
            # windows are read from the mapping a chunk at a time
            fps = np.load(file, mmap_mode="r")[:max_fps]
            if not input_is_packed:
                fps = pack_fingerprints(np.asarray(fps, dtype=np.uint8))
            if forest is None:
                feats = n_features if n_features is not None else fps.shape[1] * 8
                forest = ShardedForest(
                    feats,
                    mesh,
                    threshold=threshold,
                    merge_criterion=merge_criterion,
                    tolerance=tolerance,
                    merge_criterion_merge=refine_merge_criterion,
                    merge_threshold_change=refine_threshold_change,
                    batch_size=batch_size,
                    # Shrink the scan window so small inputs do not pay the
                    # full 16-batch window's group-table headroom (same
                    # clamp as parallel.sharded_fit)
                    scan_batches=max(
                        1, min(16, -(-total_rows // (mesh.size * batch_size)))
                    ),
                    # Sized to the input (capacity grows on demand per merge
                    # round): every capacity-shaped device op pays for the
                    # table slots, used or not
                    initial_capacity=max(
                        2 * batch_size + 2,
                        min(
                            total_rows + batch_size + 1,
                            (total_rows // mesh.size) * 2 + 2 * batch_size,
                        ),
                    ),
                )
            forest.fit_packed(fps)
    assert forest is not None
    timer.end_timing("fit", console)
    timer.init_timing("merge")
    with console.status("[italic]Merging shards...[/italic]", spinner="dots"):
        forest.merge()
    timer.end_timing("merge", console)

    for r in range(refine_rounds):
        with console.status(
            f"[italic]Refinement, round {r + 1} (sharded)...[/italic]",
            spinner="dots",
        ):
            forest.refine_inplace(
                input_files if len(input_files) > 1 else input_files[0],
                input_is_packed=input_is_packed,
                n_largest=refine_num,
                threshold=threshold + refine_threshold_change,
                merge_criterion=refine_merge_criterion,
                tolerance=tolerance,
                # The refined threshold already carries the delta; zero the
                # stored fit->merge change so the reduction rounds run at
                # threshold + change, not threshold + 2 * change
                merge_threshold_change=0.0,
            )
    for r in range(recluster_rounds):
        with console.status(
            f"[italic]Reclustering, round {r + 1} (sharded)...[/italic]",
            spinner="dots",
        ):
            forest.recluster_inplace(shuffle=recluster_shuffle)

    labels = forest.labels()
    sizes = forest.cluster_sizes()
    num_clusters = forest.num_clusters
    # Clusters sorted by size desc (stable), like the other engines
    order = np.argsort(-sizes, kind="stable")
    sort_idx = np.argsort(labels, kind="stable")
    bounds = np.searchsorted(labels[sort_idx], np.arange(num_clusters + 1)).tolist()
    flat = sort_idx.tolist()
    clusters = [flat[bounds[i] : bounds[i + 1]] for i in order]
    with open(out_dir / "clusters.pkl", "wb") as f:
        pickle.dump(clusters, f)
    if save_centroids:
        ls = forest.linear_sums()
        cent = np.where(
            (sizes > 1)[:, None], ls >= (sizes[:, None] * 0.5), np.clip(ls, 0, 1)
        ).astype(np.uint8)
        packed = np.packbits(cent, axis=-1)
        with open(out_dir / "cluster-centroids-packed.pkl", "wb") as f:
            pickle.dump([packed[i] for i in order], f)
    config["n_clusters"] = int(num_clusters)
    config["n_devices"] = mesh.size
    config["device_table_bytes_per_device"] = forest.state_bytes_per_device()


def _multiround(args: argparse.Namespace) -> None:
    r"""Parallel multi-round clustering over many `*.npy` shards."""
    from bblean_tpu_torch._memory import launch_monitor_rss_daemon
    from bblean_tpu_torch.multiround import run_multiround_bitbirch
    from bblean_tpu_torch.tree import BitBirch

    console = get_console(silent=not args.verbose)
    input_files = _discover_input_files(args.input_)
    out_dir = _make_run_dir(args.out_dir, args.overwrite)
    config: dict[str, tp.Any] = {
        "command": "multiround",
        "input_files": [str(p.resolve()) for p in input_files],
        "out_dir": str(out_dir.resolve()),
        "branching_factor": args.branching_factor,
        "threshold": args.threshold,
        "initial_merge_criterion": args.initial_merge_criterion,
        "midsection_merge_criterion": args.midsection_merge_criterion,
        "final_merge_criterion": args.final_merge_criterion,
        "tolerance": args.tolerance,
        "num_processes": args.num_initial_processes,
        "num_midsection_rounds": args.num_midsection_rounds,
        "bin_size": args.bin_size,
        "refinement_before_midsection": args.refinement_before_midsection,
        "n_features": args.n_features,
        "input_is_packed": args.input_is_packed,
        "host_engine": BitBirch(
            merge_criterion=args.initial_merge_criterion
        ).engine_name,
    }
    console.print_banner()
    console.print_multiround_config(config)
    if args.monitor_rss:
        launch_monitor_rss_daemon(out_dir)

    timer = run_multiround_bitbirch(
        input_files,
        out_dir,
        n_features=args.n_features,
        input_is_packed=args.input_is_packed,
        num_initial_processes=args.num_initial_processes,
        num_midsection_processes=args.num_midsection_processes,
        initial_merge_criterion=args.initial_merge_criterion,
        branching_factor=args.branching_factor,
        threshold=args.threshold,
        midsection_threshold_change=args.midsection_threshold_change,
        tolerance=args.tolerance,
        num_midsection_rounds=args.num_midsection_rounds,
        bin_size=args.bin_size,
        refinement_before_midsection=args.refinement_before_midsection,
        split_largest_after_each_midsection_round=args.split_largest,
        midsection_merge_criterion=args.midsection_merge_criterion,
        final_merge_criterion=args.final_merge_criterion,
        save_tree=args.save_tree,
        save_centroids=args.save_centroids,
        max_fps=args.max_fps,
        verbose=args.verbose,
        cleanup=args.cleanup,
    )
    _finish_run(args, config, console, timer, out_dir, input_files)


# -- fingerprint file commands --------------------------------------------------


def _fps_info(args: argparse.Namespace) -> None:
    from bblean_tpu_torch.fingerprints import _print_fps_file_info

    for f in args.files:
        _print_fps_file_info(Path(f))


def _fps_split(args: argparse.Namespace) -> None:
    input_: Path = args.input_
    num_splits, split_size = args.num_splits, args.split_size
    fps = np.load(input_, mmap_mode="r")
    if (num_splits is None) == (split_size is None):
        raise CliError("Pass exactly one of -n/--num-splits or --split-size")
    if num_splits is not None:
        split_size = -(-len(fps) // num_splits)
    out_dir = args.out_dir if args.out_dir is not None else input_.parent
    out_dir.mkdir(exist_ok=True, parents=True)
    total = -(-len(fps) // split_size)
    digits = len(str(total))
    for i in range(total):
        shard = fps[i * split_size : (i + 1) * split_size]
        np.save(out_dir / f"{input_.stem}.{str(i).zfill(digits)}.npy", shard)
    print(f"Wrote {total} shards to {out_dir}")


def _fps_shuffle(args: argparse.Namespace) -> None:
    rng = np.random.default_rng(args.seed)
    for f in args.files:
        fps = np.load(f)
        rng.shuffle(fps)
        out = f.with_name(f"{f.stem}.{args.suffix}.npy")
        np.save(out, fps)
        print(f"Wrote {out}")


def _fps_merge(args: argparse.Namespace) -> None:
    arrays = [np.load(f, mmap_mode="r") for f in args.files]
    widths = {a.shape[1] for a in arrays}
    if len(widths) != 1:
        raise CliError(f"Incompatible fingerprint widths: {widths}")
    merged = np.concatenate([np.asarray(a) for a in arrays])
    np.save(args.output, merged)
    print(f"Wrote {len(merged)} fingerprints to {args.output}")


def _fps_from_smiles(args: argparse.Namespace) -> None:
    r"""Featurize `*.smi` files into packed fingerprint `*.npy` files."""
    import multiprocessing as mp

    from bblean_tpu_torch.fingerprints import _FingerprintFileCreator, fps_from_smiles
    from bblean_tpu_torch.smiles import (
        _iter_idxs_and_smiles_batches,
        iter_smiles_from_paths,
    )

    console = get_console(args.verbose)
    out_dir, out_name = args.out_dir, args.out_name
    out_dir.mkdir(exist_ok=True, parents=True)
    files = [Path(f) for f in args.smiles_files]
    if args.num_processes > 1 and args.single_file:
        _fps_from_smiles_shared_memory(files, args, console)
        return
    if args.num_processes <= 1:
        smiles = list(iter_smiles_from_paths(files))
        result = fps_from_smiles(
            smiles, kind=args.kind, n_features=args.n_features,
            sanitize=args.sanitize, skip_invalid=args.skip_invalid, pack=args.pack,
        )
        if args.skip_invalid:
            fps, invalid = result
            if len(invalid):
                console.print(f"Skipped {len(invalid)} invalid smiles")
                np.save(out_dir / f"invalid-{out_name}.npy", invalid)
        else:
            fps = result
        np.save(out_dir / out_name, fps)
        console.print(f"Wrote {len(fps)} fingerprints to {out_dir / out_name}.npy")
        return

    batches = list(_iter_idxs_and_smiles_batches(files, args.batch_size))
    digits = len(str(len(batches)))
    worker = _FingerprintFileCreator(
        dtype="uint8", out_dir=out_dir, out_name=out_name, digits=digits,
        pack=args.pack, kind=args.kind, n_features=args.n_features,
        sanitize=args.sanitize, skip_invalid=args.skip_invalid,
        verbose=args.verbose,
    )
    ctx = mp.get_context("forkserver" if sys.platform == "linux" else None)
    with ctx.Pool(processes=min(args.num_processes, len(batches))) as pool:
        pool.map(worker, batches)
    console.print(f"Wrote {len(batches)} fingerprint files to {out_dir}")


def _fps_from_smiles_shared_memory(files: list[Path], args: argparse.Namespace, console) -> None:
    r"""Parallel featurization into ONE output ``.npy``.

    Workers write disjoint row ranges of a ``multiprocessing.shared_memory``
    array plus an invalid-row bitmask; invalid rows are dropped at the end.
    """
    import multiprocessing as mp
    import multiprocessing.shared_memory as shmem

    from bblean_tpu_torch.fingerprints import _FingerprintArrayFiller
    from bblean_tpu_torch.smiles import _iter_ranges_and_smiles_batches, calc_num_smiles

    out_dir, out_name = args.out_dir, args.out_name
    num_smiles = calc_num_smiles(files)
    out_dim = (args.n_features + 7) // 8 if args.pack else args.n_features
    fps_shm = shmem.SharedMemory(create=True, size=max(num_smiles * out_dim, 1))
    mask_shm = shmem.SharedMemory(create=True, size=max(num_smiles, 1))
    try:
        # Zero the invalid mask: SharedMemory contents are not guaranteed
        np.ndarray((num_smiles,), dtype=np.bool_, buffer=mask_shm.buf)[:] = False
        filler = _FingerprintArrayFiller(
            invalid_mask_shmem_name=mask_shm.name,
            shmem_name=fps_shm.name,
            kind=args.kind,
            fp_size=args.n_features,
            pack=args.pack,
            dtype="uint8",
            num_smiles=num_smiles,
            sanitize=args.sanitize,
            skip_invalid=args.skip_invalid,
        )
        ctx = mp.get_context("forkserver" if sys.platform == "linux" else None)
        with ctx.Pool(processes=args.num_processes) as pool:
            pool.starmap(filler, _iter_ranges_and_smiles_batches(files, args.batch_size))
        fps = np.ndarray((num_smiles, out_dim), dtype=np.uint8, buffer=fps_shm.buf)
        mask = np.ndarray((num_smiles,), dtype=np.bool_, buffer=mask_shm.buf)
        if args.skip_invalid and mask.any():
            invalid = mask.nonzero()[0]
            fps = np.delete(fps, invalid, axis=0)
            np.save(out_dir / f"invalid-{out_name}.npy", invalid)
            console.print(f"Skipped {invalid.size} invalid smiles")
        else:
            fps = fps.copy()  # detach from shared memory before unlink
        np.save(out_dir / out_name, fps)
        console.print(f"Wrote {len(fps)} fingerprints to {out_dir / out_name}.npy")
    finally:
        fps_shm.close()
        fps_shm.unlink()
        mask_shm.close()
        mask_shm.unlink()


# -- analysis commands ----------------------------------------------------------


def _load_run_dir(run_dir: Path) -> tuple[list[list[int]], tp.Any]:
    r"""A run directory's clusters and its fingerprints argument for
    ``cluster_analysis``: None without ``input-fps/`` files, the path of
    one file, or the list of several."""
    clusters_path = run_dir / "clusters.pkl"
    if not clusters_path.exists():
        raise CliError(f"{clusters_path} not found")
    with open(clusters_path, "rb") as f:
        clusters = pickle.load(f)
    fps_dir = run_dir / "input-fps"
    fps_files = sorted(fps_dir.glob("*.npy")) if fps_dir.is_dir() else []
    if not fps_files:
        return clusters, None
    return clusters, fps_files[0] if len(fps_files) == 1 else fps_files


def _summary(args: argparse.Namespace) -> None:
    r"""Summarize the clusters of a `run`/`multiround` output dir."""
    from bblean_tpu_torch._console import table
    from bblean_tpu_torch.analysis import cluster_analysis

    console = get_console(True)
    clusters, fps_arg = _load_run_dir(args.run_dir)
    ca = cluster_analysis(clusters, fps=fps_arg, top=args.top, min_size=args.min_size)

    console.print(f"Total fingerprints: {ca.total_fps:,}")
    console.print(f"Total clusters: {ca.all_clusters_num:,}")
    console.print(f"Singletons: {ca.all_singletons_num:,}")
    console.print(
        "Cluster sizes: "
        f"mean={ca.all_clusters_mean_size:.1f}"
        f" median={ca.all_clusters_median_size}"
        f" q1={ca.all_clusters_q1} q3={ca.all_clusters_q3}"
        f" max={ca.all_clusters_max_size}"
    )
    columns = ["label", "size"] + (["iSIM"] if ca.has_fps else [])
    rows = []
    for i in range(ca.clusters_num):
        row = [str(ca.labels[i]), str(ca.sizes[i])]
        if ca.has_fps:
            row.append(f"{ca.isims[i]:.4f}")
        rows.append(row)
    console.print(table(f"Top {ca.clusters_num} clusters", columns, rows))

    if (args.chi or args.dbi or args.dunn) and ca.has_fps:
        cluster_fps = [c for c in ca.get_top_cluster_fps() if len(c) >= 1]
        from bblean_tpu_torch import metrics

        if args.chi:
            console.print(f"CHI (higher better): {metrics.jt_isim_chi(cluster_fps):.4f}")
        if args.dbi:
            console.print(f"DBI (lower better): {metrics.jt_dbi(cluster_fps):.4f}")
        if args.dunn:
            console.print(f"Dunn (higher better): {metrics.jt_isim_dunn(cluster_fps):.4f}")
    if args.dump_metrics_path is not None:
        ca.dump_metrics(args.dump_metrics_path)
        console.print(f"Metrics dumped to {args.dump_metrics_path}")


def _plot(args: argparse.Namespace) -> None:
    r"""One ``plot-*`` command: ``plotting.<kind>_plot_from_clusters`` on the
    run directory's clusters and input files, into ``<run dir>/<kind>.png``
    unless ``-o`` names the file."""
    from bblean_tpu_torch import plotting

    clusters, fps_arg = _load_run_dir(args.run_dir)
    out = args.output or args.run_dir / f"{args.kind}.png"
    extra = {"device": args.device} if args.kind == "tsne" else {}
    getattr(plotting, f"{args.kind}_plot_from_clusters")(
        clusters, fps_arg, top=args.top, output=out, **extra
    )
    print(f"Wrote {out}")


class _VersionAction(argparse.Action):
    r"""``--version``: the installed distribution's version, printed as
    click's ``version_option`` prints ``bb``'s."""

    def __init__(self, option_strings, dest=argparse.SUPPRESS, default=argparse.SUPPRESS, help=None):
        super().__init__(option_strings, dest=dest, default=default, nargs=0, help=help)

    def __call__(self, parser, namespace, values, option_string=None) -> None:
        from importlib import metadata

        try:
            version = metadata.version(DISTRIBUTION)
        except metadata.PackageNotFoundError:
            parser.exit(1, f"Error: the distribution {DISTRIBUTION!r} is not installed, so it has no version\n")
        print(f"{PROG}, version {version}")
        parser.exit()


# -- parser ---------------------------------------------------------------------


def _flag_pair(p, on: tp.Sequence[str], off: tp.Sequence[str], dest: str,
               default: bool, help: str | None = None) -> None:
    r"""A boolean option with an "on" and an "off" spelling."""
    p.add_argument(*on, dest=dest, action="store_true", default=default, help=help)
    p.add_argument(
        *off, dest=dest, action="store_false", default=default,
        help=argparse.SUPPRESS if help == argparse.SUPPRESS else None,
    )


def _build_parser() -> argparse.ArgumentParser:
    hidden = argparse.SUPPRESS
    parser = argparse.ArgumentParser(
        prog=PROG,
        description="BitBIRCH clustering of molecular libraries on PyTorch + CUDA.",
    )
    parser.add_argument("--version", action=_VersionAction, help="Show the version and exit")
    sub = parser.add_subparsers(dest="command", required=True, metavar="COMMAND")

    p = sub.add_parser(
        "run", help="Run BitBIRCH clustering over `*.npy` fingerprint files",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.set_defaults(func=_run, parser=p)
    p.add_argument("input_", metavar="INPUT", nargs="?", type=Path, default=None)
    p.add_argument("-o", "--out-dir", type=Path, default=None, help="Dir to dump the output files")
    p.add_argument("--overwrite", action="store_true", help="Allow overwriting output files")
    p.add_argument("-b", "--branching", dest="branching_factor", type=int, default=DEFAULTS.branching_factor, help="BitBIRCH branching factor")
    p.add_argument("-t", "--threshold", type=float, default=DEFAULTS.threshold, help="Threshold for merge criterion")
    p.add_argument("--refine-threshold-change", type=float, default=DEFAULTS.refine_threshold_change, help="Threshold delta for the refinement criterion")
    _flag_pair(p, ["--save-tree"], ["--no-save-tree"], "save_tree", False)
    _flag_pair(p, ["--save-centroids"], ["--no-save-centroids"], "save_centroids", True)
    p.add_argument("-m", "--set-merge", dest="merge_criterion", default=DEFAULTS.merge_criterion, help="Merge criterion for initial clustering")
    p.add_argument("--set-refine-merge", dest="refine_merge_criterion", default=DEFAULTS.refine_merge_criterion, help="Merge criterion for refinement")
    p.add_argument("--tolerance", type=float, default=DEFAULTS.tolerance)
    p.add_argument("--refine-num", type=int, default=0, help="Num. of largest clusters to refine (0 = no refinement)")
    p.add_argument("--refine-rounds", type=int, default=None, help=hidden)
    p.add_argument("--recluster-rounds", type=int, default=0, help=hidden)
    _flag_pair(p, ["--recluster-shuffle"], ["--no-recluster-shuffle"], "recluster_shuffle", True, help=hidden)
    p.add_argument("--n-features", type=int, default=None, help="Fingerprint bit count (needed for packed inputs not a multiple of 8)")
    _flag_pair(p, ["--packed-input"], ["--unpacked-input"], "input_is_packed", True)
    p.add_argument("--engine", choices=["exact", "batch", "sharded"], default="exact", help="exact: reference-identical labels on the host (native C++ engine, or the Python engine where it cannot be built or BBLEAN_TPU_NO_EXTENSIONS=1); batch: the batched engine on the device; sharded: one batched forest per visible device, merged pairwise")
    p.add_argument("--device", default="cuda", help="[batch, sharded engines] where the engine runs: a CUDA device (sharded: every visible one), or cpu for the plain PyTorch path; the exact engine runs on the host and ignores it")
    p.add_argument("--batch-size", dest="engine_batch_size", type=int, default=8192, help="[batch, sharded engines] rows per device step")
    p.add_argument("--fanout", dest="engine_fanout", type=int, default=None, help="[batch engine] clusters per group before a split (default: auto-tuned from the input size)")
    _flag_pair(p, ["--monitor-mem"], ["--no-monitor-mem"], "monitor_rss", True)
    p.add_argument("--monitor-mem-seconds", dest="monitor_rss_interval_s", type=float, default=1.0, help=hidden)
    p.add_argument("--max-fps", type=int, default=None, help=hidden)
    _flag_pair(p, ["--copy"], ["--no-copy"], "copy_inputs", False, help="Copy input files instead of symlinking")
    _flag_pair(p, ["-v", "--verbose"], ["-V", "--no-verbose"], "verbose", True)

    p = sub.add_parser(
        "multiround", help="Parallel multi-round clustering over many `*.npy` shards",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.set_defaults(func=_multiround, parser=p)
    p.add_argument("input_", metavar="INPUT", nargs="?", type=Path, default=None)
    p.add_argument("-o", "--out-dir", type=Path, default=None)
    p.add_argument("--overwrite", action="store_true")
    p.add_argument("-b", "--branching", dest="branching_factor", type=int, default=DEFAULTS.branching_factor)
    p.add_argument("-t", "--threshold", type=float, default=DEFAULTS.threshold)
    p.add_argument("--midsection-threshold-change", type=float, default=DEFAULTS.refine_threshold_change)
    p.add_argument("-m", "--set-merge", dest="initial_merge_criterion", default=DEFAULTS.merge_criterion)
    p.add_argument("--set-midsection-merge", dest="midsection_merge_criterion", default=DEFAULTS.refine_merge_criterion)
    p.add_argument("--set-final-merge", dest="final_merge_criterion", default=None)
    p.add_argument("--tolerance", type=float, default=DEFAULTS.tolerance)
    p.add_argument("-p", "--num-processes", dest="num_initial_processes", type=int, default=10, help="Processes for the initial round")
    p.add_argument("--num-midsection-processes", type=int, default=None)
    p.add_argument("--num-midsection-rounds", type=int, default=1)
    p.add_argument("--bin-size", type=int, default=10)
    p.add_argument("--refinement", dest="refinement_before_midsection", choices=["full", "split", "none"], default="full")
    _flag_pair(p, ["--split-largest"], ["--no-split-largest"], "split_largest", False)
    _flag_pair(p, ["--save-tree"], ["--no-save-tree"], "save_tree", False)
    _flag_pair(p, ["--save-centroids"], ["--no-save-centroids"], "save_centroids", True)
    p.add_argument("--n-features", type=int, default=None)
    _flag_pair(p, ["--packed-input"], ["--unpacked-input"], "input_is_packed", True)
    _flag_pair(p, ["--monitor-mem"], ["--no-monitor-mem"], "monitor_rss", True)
    p.add_argument("--max-fps", type=int, default=None, help=hidden)
    _flag_pair(p, ["--cleanup"], ["--no-cleanup"], "cleanup", True)
    _flag_pair(p, ["--copy"], ["--no-copy"], "copy_inputs", False)
    _flag_pair(p, ["-v", "--verbose"], ["-V", "--no-verbose"], "verbose", True)

    p = sub.add_parser("fps-info", help="Inspect fingerprint `*.npy` files")
    p.set_defaults(func=_fps_info, parser=p)
    p.add_argument("files", nargs="+", type=Path)

    p = sub.add_parser("fps-split", help="Split a fingerprint `*.npy` file into shards")
    p.set_defaults(func=_fps_split, parser=p)
    p.add_argument("input_", metavar="INPUT", type=Path)
    p.add_argument("-n", "--num-splits", type=int, default=None)
    p.add_argument("--split-size", type=int, default=None, help="Fingerprints per shard (alternative to -n)")
    p.add_argument("-o", "--out-dir", type=Path, default=None)

    p = sub.add_parser("fps-shuffle", help="Shuffle the rows of fingerprint `*.npy` files")
    p.set_defaults(func=_fps_shuffle, parser=p)
    p.add_argument("files", nargs="+", type=Path)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--suffix", default="shuffled")

    p = sub.add_parser("fps-merge", help="Merge fingerprint `*.npy` files into one")
    p.set_defaults(func=_fps_merge, parser=p)
    p.add_argument("files", nargs="+", type=Path)
    p.add_argument("-o", "--output", type=Path, required=True)

    p = sub.add_parser(
        "fps-from-smiles",
        help="Featurize `*.smi` files into packed fingerprint `*.npy` files (requires RDKit)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.set_defaults(func=_fps_from_smiles, parser=p)
    p.add_argument("smiles_files", nargs="+", type=Path)
    p.add_argument("-o", "--out-dir", type=Path, default=Path("bb_inputs"))
    p.add_argument("--out-name", default="fps")
    p.add_argument("--kind", default=DEFAULTS.fp_kind, choices=["rdkit", "ecfp4", "ecfp6"])
    p.add_argument("--n-features", type=int, default=DEFAULTS.n_features)
    p.add_argument("--sanitize", default="all", choices=["all", "minimal"])
    _flag_pair(p, ["--skip-invalid"], ["--no-skip-invalid"], "skip_invalid", False)
    _flag_pair(p, ["--pack"], ["--no-pack"], "pack", True)
    p.add_argument("-p", "--num-processes", type=int, default=1)
    p.add_argument("--batch-size", type=int, default=50_000, help="SMILES per output file in parallel mode")
    _flag_pair(
        p, ["--single-file"], ["--multi-file"], "single_file", False,
        help="In parallel mode, featurize into ONE output array via shared memory instead of one .npy per batch",
    )
    _flag_pair(p, ["-v", "--verbose"], ["-V", "--no-verbose"], "verbose", True)

    p = sub.add_parser(
        "summary", help="Summarize the clusters of a `bb-torch run`/`multiround` output dir",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.set_defaults(func=_summary, parser=p)
    p.add_argument("run_dir", type=Path)
    p.add_argument("--top", type=int, default=20)
    p.add_argument("--min-size", type=int, default=0)
    _flag_pair(p, ["--chi"], ["--no-chi"], "chi", False, help="Compute the CHI quality index")
    _flag_pair(p, ["--dbi"], ["--no-dbi"], "dbi", False, help="Compute the DBI quality index")
    _flag_pair(p, ["--dunn"], ["--no-dunn"], "dunn", False, help="Compute the Dunn quality index")
    p.add_argument("--dump-metrics", dest="dump_metrics_path", type=Path, default=None)

    plots = {
        "summary": "Bar + iSIM summary plot of a run dir",
        "pops": "Cluster population KDE plot of a run dir",
        "pca": "PCA embedding plot of the top clusters",
        "tsne": "t-SNE embedding plot of the top clusters",
        "umap": "UMAP embedding plot of the top clusters",
    }
    for kind, text in plots.items():
        p = sub.add_parser(
            f"plot-{kind}", help=text, formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        )
        p.set_defaults(func=_plot, parser=p, kind=kind)
        p.add_argument("run_dir", type=Path)
        p.add_argument("--top", type=int, default=20)
        p.add_argument("-o", "--output", type=Path, default=None)
        if kind == "tsne":
            p.add_argument("--device", default="cuda", help="where the t-SNE runs when openTSNE is not installed: a CUDA device, or cpu for the plain PyTorch path")
    return parser


def main(argv: tp.Sequence[str] | None = None) -> None:
    r"""Parse ``argv`` (default ``sys.argv[1:]``) and run the command."""
    parser = _build_parser()
    args = parser.parse_args(argv)
    try:
        args.func(args)
    except (CliError, ImportError) as err:
        # A missing optional package (RDKit, matplotlib, ...) is the
        # user's to install: its message names it
        print(f"Error: {err}", file=sys.stderr)
        raise SystemExit(1) from err


if __name__ == "__main__":
    main()
