"""One torch.profiler session over a traced stretch of a run, reduced to
plain (name, start, end) events: the device's busy time as the union of
kernel intervals, its idle gaps labelled with the host operation running
in each, and device time by kernel name.

The arithmetic of the idle gaps and of telling the profiler's mirrored
annotations from kernels is a copy of the port's `profile_window`
(`hoig_torch/utils/profiling.py`), kept here so that the yardstick does not
move with the program. Times are microseconds from the trace's first event.
"""

from __future__ import annotations

import bisect
import contextlib
import re

import torch

REGION = "hoig_bench_traced"


@contextlib.contextmanager
def profiled():
    """Profile the enclosed block (CPU and CUDA activity, one session per
    process); yields a dict that holds, after the block, the raw events:
    "device" [(name, start, end)], "host" [(name, start, end)] and "span"
    (start, end) of the traced region."""
    from torch.profiler import ProfilerActivity, profile, record_function

    out: dict = {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(REGION):
            yield out
            torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    kineto = list(prof.profiler.kineto_results.events())
    t0 = min((e.start_ns() for e in kineto), default=0)
    raw = [(e.name(), (e.start_ns() - t0) / 1e3, (e.end_ns() - t0) / 1e3, e.device_type() == cuda)
           for e in kineto]
    host_names = {n for n, _, _, dev in raw if not dev}
    out["span"] = next(((s, e) for n, s, e, dev in raw if n == REGION and not dev), None)
    # annotations are mirrored on the device timeline under their host
    # names: they are spans, not kernels
    out["device"] = [(n, s, e) for n, s, e, dev in raw if dev and n not in host_names]
    out["host"] = [(n, s, e) for n, s, e, dev in raw if not dev and n != REGION]


def busy_us(device: list, lo: float, hi: float) -> float:
    """The union of the kernel intervals inside [lo, hi]."""
    spans = sorted((max(s, lo), min(e, hi)) for _, s, e in device if e > lo and s < hi)
    total, t = 0.0, lo
    for s, e in spans:
        s = max(s, t)
        if e > s:
            total += e - s
            t = e
    return total


def idle_gaps(device: list, host: list, lo: float, hi: float, top: int = 10) -> list:
    """The `top` longest stretches of [lo, hi] with no kernel running,
    longest first: dict(start, us, host: the host events running when the
    gap opened, outermost first, next: the first host event begun after)."""
    busy = sorted((s, e) for _, s, e in device if e > lo and s < hi)
    gaps, t = [], lo
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    gaps.sort(key=lambda g: g[0] - g[1])
    ordered = sorted((s, -e, n) for n, s, e in host)
    starts = [h[0] for h in ordered]
    out = []
    for start, end in gaps[:top]:
        i = bisect.bisect_right(starts, start)
        running = [n for _, neg_end, n in ordered[:i] if -neg_end > start]
        out.append(dict(start=start, us=end - start, host=running,
                        next=ordered[i][2] if i < len(ordered) else None))
    return out


def gap_label(gap: dict) -> str:
    """What the host was doing in a gap: the innermost op running, else the
    op it began next."""
    if gap["host"]:
        return gap["host"][-1][:120]
    return f"(between ops) next: {gap['next']}"[:120]


def by_kernel(device: list, lo: float, hi: float) -> dict:
    """{kernel name: device us} of the kernels that start in [lo, hi]."""
    out: dict = {}
    for n, s, e in device:
        if lo <= s <= hi:
            out[n] = out.get(n, 0.0) + (e - s)
    return out


def whole_word(names) -> list:
    """Patterns that find a kernel's function name as a whole word of the
    profiler's kernel name (dw_kernel is not dw_tc_kernel, gather_kernel is
    not aten's vectorized_gather_kernel)."""
    return [re.compile(rf"(?<![A-Za-z_]){re.escape(n)}(?![a-z_])") for n in names]


def summary(events: dict, top: int = 10) -> dict:
    """busy_s, window_s and the breakdown of a traced stretch."""
    lo, hi = events["span"]
    dev, host = events["device"], events["host"]
    kernels = by_kernel(dev, lo, hi)
    gaps = idle_gaps(dev, host, lo, hi, top)
    return dict(
        busy_s=busy_us(dev, lo, hi) / 1e6,
        window_s=(hi - lo) / 1e6,
        breakdown=dict(
            device_ops=[[n[:120], us / 1e6] for n, us in
                        sorted(kernels.items(), key=lambda kv: -kv[1])[:top]],
            idle_gaps=[[gap_label(g), g["us"] / 1e6] for g in gaps]),
    )
