"""Launch calls per traced call that start inside the conditioning (span
`conditioning`)."""

from benchmark.lib import spans


def read(run):
    return spans.launches(run, "conditioning")
