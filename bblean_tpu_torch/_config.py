r"""CLI defaults and run-metadata (``config.json``) collection.

A copy of ``bblean_tpu/_config.py``: the defaults are those of the
reference CLI; the spec dump names the CUDA devices and, for a run on one,
its memory statistics.
"""

from __future__ import annotations

import dataclasses
import json
import multiprocessing as mp
import os
import sys
import typing as tp
from pathlib import Path


@dataclasses.dataclass(slots=True)
class BitBirchConfig:
    threshold: float = 0.30
    branching_factor: int = 254
    merge_criterion: str = "diameter"
    refine_merge_criterion: str = "tolerance-diameter"
    refine_threshold_change: float = 0.0
    tolerance: float = 0.05
    n_features: int = 2048
    fp_kind: str = "ecfp4"


DEFAULTS = BitBirchConfig()

TSNE_SEED = 42


def _host_specs() -> dict[str, tp.Any]:
    r"""Hardware / software environment facts worth recording per run."""
    import numpy as np
    import torch

    from bblean_tpu_torch._memory import system_mem_gib
    from bblean_tpu_torch.utils import (
        _cpu_name,
        _cuda_device_names,
        native_extensions_are_enabled,
        native_extensions_are_installed,
    )

    total_mem, avail_mem = system_mem_gib()
    return {
        "native_extensions_enabled": native_extensions_are_enabled(),
        "native_extensions_installed": native_extensions_are_installed(),
        "total_memory_gib": total_mem,
        "initial_available_memory_gib": avail_mem,
        "platform": sys.platform,
        "cpu": _cpu_name(),
        "accelerators": _cuda_device_names(),
        "numpy_version": np.__version__,
        "torch_version": torch.__version__,
        "python_version": sys.version.split()[0],
    }


def collect_system_specs_and_dump_config(config: dict[str, tp.Any]) -> None:
    r"""Write ``<out_dir>/config.json``: run params + system specs, and the
    memory statistics of ``config["device"]`` when that is a CUDA device."""
    from bblean_tpu_torch._memory import device_memory_stats

    record = dict(config)
    record.update(_host_specs())
    hbm = device_memory_stats(record.get("device", "cpu"))
    if hbm is not None:
        record["device_memory"] = hbm
    if record.get("num_processes", 1) > 1:
        record["multiprocessing_start_method"] = mp.get_start_method()
        record["visible_cpu_cores"] = os.cpu_count()
    out = Path(record["out_dir"]) / "config.json"
    out.write_text(json.dumps(record, indent=4), encoding="utf-8")
