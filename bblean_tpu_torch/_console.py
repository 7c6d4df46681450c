r"""Console with banner/config printing + silent null-object variant.

A copy of ``bblean_tpu/_console.py``.  The console is rich's where ``rich``
is installed; where it is not, a plain one that prints the same text with
the style tags removed and shows no spinner.
"""

from __future__ import annotations

import contextlib
import os
import re
import typing as tp
from pathlib import Path

__all__ = ["get_console", "table"]

_BANNER = r"""
 _     _     _
| |__ | |__ | | ___  __ _ _ __
| '_ \| '_ \| |/ _ \/ _` | '_ \
| |_) | |_) | |  __/ (_| | | | |
|_.__/|_.__/|_|\___|\__,_|_| |_|
   BitBIRCH molecular clustering on PyTorch + CUDA
"""

_STYLE_TAG = re.compile(r"\[/?[a-z][a-z ]*\]")


class _PlainConsole:
    r"""What the port uses of ``rich.console.Console``, on ``print``."""

    def print(self, *args: tp.Any, **_kwargs: tp.Any) -> None:
        print(*(_STYLE_TAG.sub("", str(a)) for a in args), flush=True)

    def status(self, *_args: tp.Any, **_kwargs: tp.Any) -> tp.ContextManager:
        return contextlib.nullcontext()


try:
    from rich.console import Console as _Console
except ImportError:  # rich is cosmetic: print plainly without it
    _Console = _PlainConsole


class BBConsole(_Console):  # type: ignore[misc, valid-type]
    r"""Console with the port's banner and config pretty-printing."""

    def print_banner(self) -> None:
        if os.getenv("BITBIRCHNOBANNER") or os.getenv("BBLEAN_TPU_NOBANNER"):
            return
        self.print(f"[bold cyan]{_BANNER}[/bold cyan]", highlight=False)

    def print_config(self, config: tp.Mapping[str, tp.Any], title: str = "Config") -> None:
        self.print(f"[bold]{title}:[/bold]")
        for key, value in config.items():
            self.print(f"    - {key}: [yellow]{value}[/yellow]")
        self.print()

    def print_multiround_config(self, config: tp.Mapping[str, tp.Any]) -> None:
        self.print_config(config, title="Multi-round config")

    def print_peak_mem(self, out_dir: Path | str) -> None:
        path = Path(out_dir) / "max-rss.txt"
        if path.exists():
            self.print(f"    - Peak RSS so far: {path.read_text().strip()}")

    def print_peak_hbm(self, device: tp.Any = "cuda") -> None:
        r"""Device-memory summary line (no-op for the CPU)."""
        from bblean_tpu_torch._memory import device_memory_stats

        stats = device_memory_stats(device)
        if not stats:
            return
        line = (
            f"    - Peak device memory: {stats['peak_bytes_in_use'] / 2**30:.2f} GiB"
            f" of {stats['bytes_limit'] / 2**30:.1f} GiB"
        )
        self.print(line)


class SilentConsole:
    r"""Null-object console used under ``--no-verbose``."""

    def print(self, *args: tp.Any, **kwargs: tp.Any) -> None:
        pass

    def print_banner(self) -> None:
        pass

    def print_config(self, *args: tp.Any, **kwargs: tp.Any) -> None:
        pass

    def print_multiround_config(self, *args: tp.Any, **kwargs: tp.Any) -> None:
        pass

    def print_peak_mem(self, *args: tp.Any, **kwargs: tp.Any) -> None:
        pass

    def print_peak_hbm(self, *args: tp.Any, **kwargs: tp.Any) -> None:
        pass

    def status(self, *args: tp.Any, **kwargs: tp.Any) -> tp.ContextManager:
        return contextlib.nullcontext()


def table(title: str, columns: tp.Sequence[str], rows: tp.Sequence[tp.Sequence[str]]) -> tp.Any:
    r"""A table for ``console.print``: rich's ``Table`` where rich is
    installed, else the title over left-aligned columns, as plain text."""
    try:
        from rich.table import Table
    except ImportError:
        lines = [list(columns), *map(list, rows)]
        widths = [max(len(line[i]) for line in lines) for i in range(len(columns))]
        text = ["  ".join(v.ljust(w) for v, w in zip(line, widths)).rstrip() for line in lines]
        return "\n".join([title, *text])
    out = Table(title=title)
    for name in columns:
        out.add_column(name)
    for row in rows:
        out.add_row(*row)
    return out


def get_console(verbose: bool = True, silent: bool | None = None) -> tp.Any:
    r"""Console factory: a BBConsole, or a silent null object."""
    if silent is None:
        silent = not verbose
    if silent:
        return SilentConsole()
    return BBConsole()
