"""Stream ms per traced step of the step's conditioning (span `conditioning`)."""

from benchmark.lib import spans


def read(run):
    return spans.stream_ms(run, "conditioning")
