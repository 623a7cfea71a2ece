"""The hand-written kernels' least time over their device time, traced steps."""

from benchmark.lib import readings


def read(run):
    return readings.roofline_pct(run)
