"""Images of all serving calls completed in the window over its wall time."""


def read(run):
    return run.loop.calls * run.batch / run.loop.window_s
