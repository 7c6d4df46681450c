r"""Sharded clustering over a mesh of devices.

The twin of ``examples/multi_device.py``.  By default the mesh is every
visible CUDA card, one shard each, as the JAX script's is every visible
device.  ``--shards N`` puts N shards on the one ``--device`` instead,
which is how the multi-shard path runs on one card or on the CPU (the
counterpart of ``--xla_force_host_platform_device_count``)::

    python3 -m bblean_tpu_torch.examples.multi_device [--device cpu] [--shards 8]

Where JAX's mesh runs its shards at once over the interconnect, the port's
mesh is a tuple of devices in one process and its shards run one after
another, on several cards too: the result is the same, the wall is not.
"""

from __future__ import annotations

import argparse
import typing as tp

import numpy as np
import torch

from bblean_tpu_torch.examples import parse_args
from bblean_tpu_torch.fingerprints import make_fake_fingerprints
from bblean_tpu_torch.parallel import get_mesh, sharded_fit
from bblean_tpu_torch.similarity import jt_isim_from_sum


def _add_shards(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--shards",
        type=int,
        default=None,
        help="put this many shards on --device (default: one shard per "
        "visible card, or one CPU shard)",
    )


def main(argv: tp.Sequence[str] | None = None) -> None:
    args, device = parse_args(__doc__, argv, _add_shards)
    fps = make_fake_fingerprints(20_000, n_features=2048, seed=3, pack=True)

    if args.shards is None:
        mesh = get_mesh(device=device)  # 1-D mesh over every visible card
    else:
        mesh = get_mesh(devices=[device] * args.shards)
    dev = mesh.devices[0]
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type
    print(f"devices: {mesh.size} x {kind}")

    result = sharded_fit(
        fps,
        mesh,
        input_is_packed=True,
        threshold=0.30,
        merge_criterion="diameter",
        # Merge rounds may use a laxer criterion, like multiround's midsection:
        merge_criterion_merge="tolerance-diameter",
        batch_size=512,
    )

    print(f"{result.num_clusters} clusters over {len(result.labels)} rows")
    sizes = np.sort(result.sizes)[::-1]
    print(f"largest: {sizes[:5].tolist()}")

    # Cohesion invariant: every multi-member cluster satisfies the criterion
    worst = 1.0
    for ls, n in zip(result.linear_sums, result.sizes):
        if n >= 2:
            worst = min(worst, jt_isim_from_sum(ls.astype(np.uint64), int(n)))
    print(f"worst multi-member cluster iSIM: {worst:.3f} (threshold 0.30)")


if __name__ == "__main__":
    main()
