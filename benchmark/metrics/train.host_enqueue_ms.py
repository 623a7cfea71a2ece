"""Host ms per traced step inside the step (span `train_step`): the
program's dispatch, time blocked on a full launch queue included."""

from benchmark.lib import spans


def read(run):
    return spans.host_ms(run, "train_step")
