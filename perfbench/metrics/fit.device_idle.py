r"""fit.device_idle: the share of an unprofiled fit's wall in which no
kernel, copy or memset ran on the device: 1 - (union of their intervals
in the profiled fit) / the median wall of the window's unprofiled fits.
Recording the host's events stretches the profiled fit's wall (at 1M rows
by about half) and not its device time, so its own wall would read the
profiler's overhead as idle time."""

from perfbench import trace


def read(obs):
    if not obs.device or not obs.untraced_ns:
        return None
    return 1.0 - trace.busy_ns(obs.device) / obs.untraced_ns
