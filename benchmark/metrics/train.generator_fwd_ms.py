"""Stream ms per traced step of G's forward and the composite (span `generator`)."""

from benchmark.lib import spans


def read(run):
    return spans.stream_ms(run, "generator")
