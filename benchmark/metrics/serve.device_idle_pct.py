"""Share of the traced calls' wall time with no kernel running."""

from benchmark.lib import readings


def read(run):
    return readings.idle_pct(run)
