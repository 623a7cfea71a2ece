"""Device ms of forward_only per call: CUDA events around it, over the window."""


def read(run):
    ms = run.loop.gen_ms
    return sum(ms) / len(ms) if ms else None
