"""Stream ms per traced step of the two Adam updates (spans `g_adam` and
`d_adam`)."""

from benchmark.lib import spans


def read(run):
    return spans.stream_ms(run, "g_adam", "d_adam")
