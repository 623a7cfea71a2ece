"""Stream ms per traced step of the G-side losses: D on the fake, VGG19, L1,
mask and TV (span `g_losses`)."""

from benchmark.lib import spans


def read(run):
    return spans.stream_ms(run, "g_losses")
