r"""Device choice of the port's entry points.

Every entry point runs on a CUDA device unless the caller asks for the
CPU: a numpy input goes to ``device`` (default ``"cuda"``, raising when no
card is available), a tensor is used where it lies.
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch

__all__ = ["require_device", "as_tensor_on"]

DeviceLike = tp.Union[str, torch.device]


def require_device(device: DeviceLike = "cuda") -> torch.device:
    r"""``torch.device(device)``; raises when it names CUDA and no CUDA
    device is available (there is no give-way to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} needs a CUDA device and none is available; "
            "ask for device 'cpu' to run the plain PyTorch path"
        )
    return dev


def as_tensor_on(x: tp.Any, device: DeviceLike | None = None) -> torch.Tensor:
    r"""``x`` as a tensor: a tensor stays on its device unless ``device``
    is given; anything else goes through numpy to ``device`` (default
    ``"cuda"``)."""
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(require_device(device))
    dev = require_device("cuda" if device is None else device)
    return torch.from_numpy(np.ascontiguousarray(x)).to(dev)
