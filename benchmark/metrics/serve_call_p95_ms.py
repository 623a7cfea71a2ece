"""The 95th percentile of every call of the window, each timed from the
hand-over of its inputs to its synchronized image."""

import statistics


def read(run):
    ms = [s * 1e3 for s in run.loop.latencies_s]
    return statistics.quantiles(ms, n=20, method="inclusive")[18] if len(ms) > 1 else None
