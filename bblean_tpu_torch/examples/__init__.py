r"""The examples of ``examples/``, on the port.

Each module is the twin of the script of the same name and prints the same
lines.  Run one from the repository root as a module, on the card (the
default) or, with ``--device cpu``, on the CPU::

    python3 -m bblean_tpu_torch.examples.quickstart --device cpu

``quickstart``, ``best_practices`` and ``dataset_splitting`` drive
``BitBirch``, which runs on the host engines whatever the device;
``multi_device`` drives the sharded engine on the device.  ``--device
cuda`` on a machine without a card raises: nothing gives way to the CPU.
"""

from __future__ import annotations

import argparse
import typing as tp

import torch

from bblean_tpu_torch._device import require_device

__all__ = ["parse_args"]


def parse_args(
    doc: str | None,
    argv: tp.Sequence[str] | None,
    add: tp.Callable[[argparse.ArgumentParser], None] | None = None,
) -> tuple[argparse.Namespace, torch.device]:
    r"""An example's arguments (``--device``, default ``cuda``, plus what
    ``add`` puts in) and its device, checked: a CUDA device raises where
    there is none."""
    parser = argparse.ArgumentParser(
        description=(doc or "").split("\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument(
        "--device",
        default="cuda",
        help="device of the run: cuda (the default) or cpu; nothing falls back",
    )
    if add is not None:
        add(parser)
    args = parser.parse_args(argv)
    return args, require_device(args.device)
