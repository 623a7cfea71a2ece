"""Device ms of flow_only per call: CUDA events around it, over the window."""


def read(run):
    ms = run.loop.cond_ms
    return sum(ms) / len(ms) if ms else None
