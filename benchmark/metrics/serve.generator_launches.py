"""Launch calls per traced call that start inside the generator (span
`generator`)."""

from benchmark.lib import spans


def read(run):
    return spans.launches(run, "generator")
