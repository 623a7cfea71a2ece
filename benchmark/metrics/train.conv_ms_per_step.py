"""Device ms per traced step of the convolution kernels (G, D and VGG19)."""

from benchmark.lib import readings, trace


def read(run):
    got = readings.traced(run)
    if got is None or not run.traced_units:
        return None
    us = readings.conv_us(trace.by_kernel(*got))
    return us / 1e3 / run.traced_units if us else None
