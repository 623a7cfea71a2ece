"""Model FLOPs of the window's calls over its wall time, % of 989 TFLOP/s."""

from benchmark.lib import readings


def read(run):
    return readings.mfu_pct(run, run.loop.calls)
