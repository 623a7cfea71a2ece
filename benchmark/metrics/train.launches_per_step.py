"""Launch calls per traced step that start inside the step (span
`train_step`)."""

from benchmark.lib import spans


def read(run):
    return spans.launches(run, "train_step")
