"""Share of the traced steps' wall time with no kernel running."""

from benchmark.lib import readings


def read(run):
    return readings.idle_pct(run)
