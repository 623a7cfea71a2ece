"""The hand-written kernels' least time over their device time, traced calls."""

from benchmark.lib import readings


def read(run):
    return readings.roofline_pct(run)
