r"""Headline benchmark of the PyTorch + CUDA port: fingerprints clustered per
second on one NVIDIA GPU.

The port of ``bench.py``.  Primary metric: **1M x 2048-bit synthetic
fingerprints at threshold 0.30** (the reference CLI's default threshold, the
merge-heavy regime) through ``BatchTree.fit_packed`` with the input resident
on the card, best of two fresh-tree runs after a warm-up.  The same JSON
line also reports the t=0.65 (singleton-heavy) regime and a re-run of the
primary with every host CPU burned by spinner processes, and the sharded
engine (``ShardedForest`` fit + merge) on a one-card mesh.

Baseline anchor: the reference's own speed-regression cap for its C++ path,
10k fps in < 0.9 s on CI, i.e. ~11.1k fps/s single-core (see BASELINE.md).

Run from the repository root on a machine with a CUDA device and ``nvcc``:
``python3 bench_cuda.py``.  There is no CPU mode: without a CUDA device it
exits non-zero and prints no result.  It prints the JSON line
{"metric", "value", "unit", "vs_baseline", ...} twice: as soon as the first
t=0.3 run is measured (the primary keys only), and completed at the end, so
that a run cut short still leaves its primary number.  Both lines name the
card and its power limit as ``nvidia-smi`` gives them.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time

# Reference anchor: 10k fps / 0.9 s (C++ ext, single core), BASELINE.md
BASELINE_FPS_PER_S = 10_000 / 0.9

N_FPS = 1_000_000
N_FEATURES = 2048
SEED = 12620509540149709235


def _timed_fit(dev_fps, threshold: float, capacity: int, ls_capacity: int):
    import torch

    from bblean_tpu_torch import BatchTree

    def build():
        return BatchTree(
            N_FEATURES,
            threshold=threshold,
            batch_size=8192,
            initial_capacity=capacity,
            ls_capacity=ls_capacity,
            device="cuda",
        )

    # Warm-up on a prefix: builds (or loads) the kernels and runs every step
    # the timed run can take once at the final table shapes, so that the
    # caching allocator holds their working set before the clock starts
    warm = build()
    warm.fit_packed(dev_fps[: 1 << 16], range(1 << 16))
    warm.warm_programs(dev_fps)
    del warm

    tree = build()
    # Mass-less warm on the TIMED tree (state unchanged)
    tree.warm_programs(dev_fps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tree.fit_packed(dev_fps, range(N_FPS))
    num = tree.num_clusters  # device sync
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    del tree
    return N_FPS / dt, dt, num


def _timed_sharded_fit(dev_fps, threshold: float):
    r"""One warmed fresh-forest ``ShardedForest`` fit + merge on a mesh of
    the first card: the whole window-dispatch and merge control plane, with
    nothing to exchange.  The input is on the card before the clock starts,
    as in the ``BatchTree`` primary."""
    import torch

    from bblean_tpu_torch.parallel import ShardedForest, get_mesh

    mesh = get_mesh(1, device="cuda")

    def build():
        return ShardedForest(
            N_FEATURES,
            mesh,
            threshold=threshold,
            batch_size=8192,
            initial_capacity=1 << 19,
            ls_capacity=1 << 18,
        )

    # Full-input warm fit: every step the timed run takes, at its table
    # shapes, so that the caching allocator holds their working set
    warm = build()
    warm.fit_packed(dev_fps)
    _ = warm.num_clusters
    del warm

    forest = build()
    forest.warm_programs(dev_fps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    forest.fit_packed(dev_fps)
    forest.merge()
    num = forest.num_clusters  # device sync
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    del forest
    return N_FPS / dt, dt, num


class _CpuHog:
    r"""Context manager burning every CPU with spinner subprocesses,
    emulating a loaded host.

    The engine's throughput should not depend on the host being quiet: the
    boundary pipeline keeps ``pipeline_depth`` windows in flight.  This
    measures that directly instead of hoping the box is idle.
    """

    def __enter__(self):
        n = os.cpu_count() or 1
        self._procs = [
            subprocess.Popen(
                [sys.executable, "-c", "while True:\n pass"],
                stdout=subprocess.DEVNULL,
                stderr=subprocess.DEVNULL,
            )
            for _ in range(n)
        ]
        return self

    def __exit__(self, *exc):
        for p in self._procs:
            p.send_signal(signal.SIGKILL)
        for p in self._procs:
            p.wait()
        return False


def _primary(rate: float, dt: float, num: int, card: str) -> dict:
    return {
        "metric": (
            f"fps_clustered_per_sec_{N_FPS // 1000}k_x{N_FEATURES}bit"
            "_diameter_t0.3"
        ),
        "value": round(rate, 1),
        "unit": "fingerprints/s",
        "vs_baseline": round(rate / BASELINE_FPS_PER_S, 2),
        "wall_s": round(dt, 2),
        "n_clusters": int(num),
        "card": card,
    }


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_cuda: torch.cuda.is_available() is False; no result")
    from bblean_tpu_torch.fingerprints import make_fake_fingerprints

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    fps = make_fake_fingerprints(N_FPS, n_features=N_FEATURES, seed=SEED)
    # Stage the packed fps on the card up-front (the reference's
    # speed-regression benchmark likewise times fit() with fps already
    # resident in RAM); the timed region below is pure clustering work
    dev_fps = torch.from_numpy(fps).to("cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # Primary: the reference's default threshold (merge-heavy regime).
    # Capacities sized so the timed run never grows a table nor drifts its
    # host-side upper bounds into a capacity-edge sync (the run ends at
    # ~398k clusters; one scan window may demand 65k free cluster+pool slots
    # before the flush refreshes the bounds).  BEST OF TWO fresh-tree runs:
    # the first full-size run also warms the allocator for the 1<<19-capacity
    # table shapes, which the prefix warm-up alone does not.
    settings03 = dict(threshold=0.30, capacity=1 << 19, ls_capacity=1 << 18)
    runs03 = [_timed_fit(dev_fps, **settings03)]
    print(json.dumps(_primary(*runs03[0], card)), flush=True)
    runs03.append(_timed_fit(dev_fps, **settings03))
    rate03, dt03, num03 = max(runs03, key=lambda r: r[0])
    # Secondary: the singleton-heavy regime (~983k clusters).  capacity
    # 1<<21, NOT 1<<20: the host-side upper bound carries one in-flight
    # window (+65k) of drift, so 1<<20 sits at the capacity edge
    rate65, dt65, num65 = _timed_fit(
        dev_fps, threshold=0.65, capacity=1 << 21, ls_capacity=1 << 18
    )
    # Contended re-run of the primary regime with every host CPU burned by
    # spinner processes, after the quiet passes, so both sides of the
    # comparison see an equally warm allocator
    with _CpuHog():
        rate03c, dt03c, _num03c = _timed_fit(dev_fps, **settings03)

    # The engine that runs on N cards, on one: ShardedForest on a one-card
    # mesh (the full window-dispatch + merge control plane)
    rate_sh, dt_sh, num_sh = _timed_sharded_fit(dev_fps, threshold=0.30)

    out = _primary(rate03, dt03, num03, card)
    out.update({
        "t0.3_contended_fps_per_s": round(rate03c, 1),
        "t0.3_contended_vs_baseline": round(rate03c / BASELINE_FPS_PER_S, 2),
        "t0.3_contended_wall_s": round(dt03c, 2),
        "t0.65_fps_per_s": round(rate65, 1),
        "t0.65_vs_baseline": round(rate65 / BASELINE_FPS_PER_S, 2),
        "t0.65_wall_s": round(dt65, 2),
        "t0.65_n_clusters": int(num65),
        "sharded_1dev_t0.3_fps_per_s": round(rate_sh, 1),
        "sharded_1dev_t0.3_vs_baseline": round(rate_sh / BASELINE_FPS_PER_S, 2),
        "sharded_1dev_t0.3_wall_s": round(dt_sh, 2),
        "sharded_1dev_t0.3_n_clusters": int(num_sh),
        "hbm_peak_gib": round(torch.cuda.max_memory_allocated() / 2**30, 2),
    })
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
