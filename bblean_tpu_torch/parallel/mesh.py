r"""Device-mesh helpers of the sharded engine.

A mesh here is an ordered tuple of ``torch.device``s, one per shard.  The
same device may be named several times: the shards then share it, which is
how the multi-shard engine runs (and is tested) on one card or on the CPU.
"""

from __future__ import annotations

import typing as tp

import torch

from bblean_tpu_torch._device import DeviceLike, require_device

__all__ = ["Mesh", "get_mesh"]


class Mesh(tp.NamedTuple):
    r"""One ``torch.device`` per shard (hashable)."""

    devices: tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)


def get_mesh(
    n_devices: int | None = None,
    device: DeviceLike = "cuda",
    devices: tp.Sequence[DeviceLike] | None = None,
) -> Mesh:
    r"""A 1-D mesh over the first ``n_devices`` devices (all by default).

    ``device="cuda"`` takes the visible CUDA devices in order and raises
    when there is none (nothing gives way to the CPU); a device with an
    index, or ``"cpu"``, gives a one-shard mesh.  ``devices`` names the
    shards' devices explicitly and may repeat one, for example
    ``["cuda:0"] * 8`` or ``["cpu"] * 8``.  Asking for more devices than
    there are raises ``ValueError``.
    """
    if devices is not None:
        devs = [require_device(d) for d in devices]
    else:
        dev = require_device(device)
        if dev.type == "cuda" and dev.index is None:
            devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        else:
            devs = [dev]
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(
                f"Requested {n_devices} devices, only {len(devs)} visible"
            )
        devs = devs[:n_devices]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return Mesh(tuple(devs))
