"""The readers of the port's program spans (`hoig_torch.utils.profiling`'s
`annotate`: a `hoig/<span>` range in the trace and a record with two CUDA
events on the current stream) for the per-layer metrics of a traced run:

- stream ms per traced step or call of the spans of some names, from the
  port's `spans()`;
- from the traced stretch's host events (`run.events["host"]`), the spans'
  host ranges: the host ms inside them, the launch calls that start inside
  them, and the share of the device's idle time whose gaps opened inside
  them.

Every reader returns None where no span was recorded (a program without
spans), so that the metric is left out of the line. Times are us, as in
`lib/trace.py`.
"""

from __future__ import annotations

import bisect

from benchmark.lib import readings, trace

PREFIX = "hoig/"
# the host calls that put a kernel, a copy or a fill on a stream
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaMemcpyAsync", "cudaMemsetAsync")


def records(run) -> list | None:
    """The port's span records of the traced stretch (the profiler records
    only there), or None."""
    if run.events is None or not run.traced_units:
        return None
    try:
        from hoig_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    return (read() if read is not None else None) or None


def stream_ms(run, *names) -> float | None:
    """Stream ms per traced step or call of the spans named `names`."""
    recs = records(run)
    if recs is None:
        return None
    ms = [r["stream_ms"] for r in recs if r["name"] in names]
    if not ms or any(m is None for m in ms):
        return None
    return sum(ms) / run.traced_units


def ranges(run, *names) -> list:
    """The sorted (start, end) host ranges of the spans named `names` in
    the traced stretch, or of every span without names."""
    if run.events is None:
        return []
    want = {PREFIX + n for n in names}
    return sorted((s, e) for n, s, e in run.events["host"]
                  if (n in want if names else n.startswith(PREFIX)))


def _merged(rs: list) -> list:
    """Sorted ranges merged where they overlap or nest."""
    out: list = []
    for s, e in rs:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _inside(merged: list, starts: list, t: float) -> bool:
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t <= merged[i][1]


def host_ms(run, *names) -> float | None:
    """Host ms per traced step or call inside the spans named `names`."""
    rs = ranges(run, *names)
    if not rs or not run.traced_units:
        return None
    return sum(e - s for s, e in _merged(rs)) / 1e3 / run.traced_units


def launches(run, *names) -> float | None:
    """Launch calls per traced step or call that start inside the spans
    named `names` (in any thread: the backward's launches too)."""
    merged = _merged(ranges(run, *names))
    if not merged or not run.traced_units:
        return None
    starts = [s for s, _ in merged]
    n = sum(1 for name, s, _ in run.events["host"]
            if name in LAUNCH_CALLS and _inside(merged, starts, s))
    return n / run.traced_units


def idle_in_program_pct(run) -> float | None:
    """The share, in %, of the traced stretch's device idle time whose gaps
    opened while the host was inside a span of the program; the rest
    opened in the caller's code."""
    got = readings.traced(run)
    merged = _merged(ranges(run))
    if got is None or not merged:
        return None
    dev, lo, hi = got
    gaps = trace.idle_gaps(dev, [], lo, hi, top=len(dev) + 1)
    total = sum(g["us"] for g in gaps)
    if not total:
        return None
    starts = [s for s, _ in merged]
    inside = sum(g["us"] for g in gaps if _inside(merged, starts, g["start"]))
    return 100.0 * inside / total
