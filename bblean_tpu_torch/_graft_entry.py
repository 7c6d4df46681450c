r"""Entry points for a quick check of the port: the flagship step on one
device, and the whole sharded program on a mesh of ``n`` shards.

``entry()`` returns the batched insert step (one level-synchronous batch
insertion into the depth-2 CF-tree, ``engine/batch.py``) with example
arguments.  ``dryrun_multichip(n)`` runs the full sharded clustering
program (per-shard fits, the state exchange, the group-gated merge rounds)
on ``n`` shards at tiny shapes.  The port of ``__graft_entry__.py``; a mesh
here can name one device ``n`` times, so nothing re-executes itself in a
subprocess with virtual devices.

Run as ``python -m bblean_tpu_torch._graft_entry [--device cpu]
[--multichip N]``.
"""

from __future__ import annotations

import numpy as np
import torch

from bblean_tpu_torch._device import DeviceLike, require_device


def entry(device: DeviceLike = "cuda"):
    r"""(step function, example args) for the batched insert step; the row
    centroids are int8, the type the engine's routing products take."""
    from bblean_tpu_torch.engine.batch import _batch_step_impl, _init_state
    from bblean_tpu_torch.fingerprints import make_fake_fingerprints

    dev = require_device(device)
    n_features, m = 2048, 256
    state = _init_state(1024, 512, 256, n_features, device=dev)
    fps = make_fake_fingerprints(m, n_features=n_features, seed=7, pack=False)
    row_ls = torch.from_numpy(fps.astype(np.int32)).to(dev)
    row_n = torch.ones((m,), dtype=torch.int32, device=dev)
    row_cent = torch.from_numpy(fps.astype(np.int8)).to(dev)
    row_pk = torch.from_numpy(np.packbits(fps, axis=-1)).to(dev)
    row_pop = torch.from_numpy(fps.sum(1).astype(np.int32)).to(dev)
    thr = torch.tensor(0.65, dtype=torch.float32, device=dev)
    tol = torch.tensor(0.05, dtype=torch.float32, device=dev)

    def step(state, row_ls, row_n, row_cent, row_pk, row_pop):
        return _batch_step_impl(
            state, row_ls, row_n, row_cent, row_pk, row_pop, thr, tol,
            criterion="diameter", block=512, max_rounds=8,
        )

    return step, (state, row_ls, row_n, row_cent, row_pk, row_pop)


def dryrun_multichip(n_devices: int, device: DeviceLike = "cuda") -> None:
    r"""Run the full sharded clustering on ``n_devices`` shards with tiny
    shapes, every shard on ``device``."""
    from bblean_tpu_torch.fingerprints import make_fake_fingerprints
    from bblean_tpu_torch.parallel import get_mesh, sharded_fit

    mesh = get_mesh(devices=[device] * n_devices)
    fps = make_fake_fingerprints(n_devices * 40, n_features=512, seed=3, pack=False)
    result = sharded_fit(
        fps, mesh, threshold=0.5, batch_size=32, tile=64, centroid_block=64,
        max_rounds=8,
    )
    assert result.labels.shape == (len(fps),)
    assert result.sizes.sum() == len(fps)
    assert result.num_clusters >= 1


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--multichip", type=int, default=None, metavar="N")
    args = parser.parse_args()
    if args.multichip is not None:
        dryrun_multichip(args.multichip, args.device)
        print(f"dryrun_multichip({args.multichip}): OK")
    else:
        fn, fn_args = entry(args.device)
        fn(*fn_args)
        print("entry(): OK")
