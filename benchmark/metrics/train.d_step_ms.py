"""Stream ms per traced step of D's losses and backward (spans `d_losses`
and `d_backward`)."""

from benchmark.lib import spans


def read(run):
    return spans.stream_ms(run, "d_losses", "d_backward")
