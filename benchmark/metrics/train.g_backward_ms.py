"""Stream ms per traced step of the G loss's backward, remat's recompute
included (span `g_backward`)."""

from benchmark.lib import spans


def read(run):
    return spans.stream_ms(run, "g_backward")
