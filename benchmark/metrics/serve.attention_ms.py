"""Stream ms per traced call of the 9 attention layers (spans `attention`)."""

from benchmark.lib import spans


def read(run):
    return spans.stream_ms(run, "attention")
