r"""refine.device_idle: the share of an unprofiled refine's wall in which no
kernel, copy or memset ran on the device: 1 - (union of their intervals in
the profiled refine) / the median wall of the window's unprofiled refines;
``fit.device_idle``'s reader, over the refine's trace."""

from pathlib import Path

from perfbench.manifest import load_module

read = load_module(Path(__file__).with_name("fit.device_idle.py")).read
