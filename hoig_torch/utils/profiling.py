"""Profiling and step timing over torch's profiler (port of
hoig_tpu/utils/profiling.py, which wraps jax.profiler).

`trace` records CPU and, where CUDA is available, CUDA activity and writes a
Chrome trace (viewable in Perfetto or chrome://tracing) into `log_dir`;
`annotate` names a region in that trace and, on CUDA, as an NVTX range;
`StepTimer` synchronises the current CUDA stream before it reads the clock,
as the JAX package's timing blocks on the step's result; `maybe_trace_steps`
traces a window of steps. The JAX package's utils/cache.py (XLA's compile
cache) has no counterpart: the port compiles nothing at run time but its
kernels, which `hoig_torch.ops._cuda` caches by source hash.

`profile_window` runs regions of work under ONE torch.profiler session (a
second session in the same process lost its device events on the H100's
machine) and splits the device time of each by kernel and operator class
(`summarize_region`, a pure function of (name, start, end, kind) events, as
are `kernel_class`, `hand_written` and `idle_gaps`); chip_smoke.py's
profiler phase and scripts/profile_step_torch.py read it. `span_ms` and
`queued_ms` time one call by CUDA events, the second with the call queued
behind a GPU sleep so that the host's launch gaps do not count.
"""

from __future__ import annotations

import bisect
import contextlib
import os
import re
import time

import torch


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _trace_path(log_dir: str) -> str:
    return os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed block; its Chrome trace lands in `log_dir`.
    Yields the `torch.profiler.profile` object (key_averages and so on)."""
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=_activities()) as prof:
        yield prof
    prof.export_chrome_trace(_trace_path(log_dir))


@contextlib.contextmanager
def annotate(name: str):
    """A named region of the trace (record_function), and an NVTX range on CUDA."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.current_stream().synchronize()


class StepTimer:
    """Per-step wall time of the enclosed block, the first `skip_first`
    steps (warm-up, the kernels' first build) left out of the mean. The CUDA
    stream is synchronised at entry and exit, so a step's time includes its
    device work."""

    def __init__(self, skip_first: int = 1):
        self.skip_first = skip_first
        self.count = 0
        self.total = 0.0
        self._t0 = None

    def __enter__(self):
        _sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _sync()
        dt = time.perf_counter() - self._t0
        self.count += 1
        if self.count > self.skip_first:
            self.total += dt

    @property
    def mean_s(self) -> float:
        n = max(1, self.count - self.skip_first)
        return self.total / n


def maybe_trace_steps(enabled: bool, log_dir: str, start_step: int, num_steps: int):
    """A step hook: call hook(step) every iteration; it traces the steps in
    [start_step, start_step + num_steps) and writes the trace into `log_dir`."""
    state = {"prof": None}

    def hook(step: int):
        if not enabled:
            return
        if step == start_step and state["prof"] is None:
            os.makedirs(log_dir, exist_ok=True)
            state["prof"] = torch.profiler.profile(activities=_activities())
            state["prof"].__enter__()
        elif step == start_step + num_steps and state["prof"] is not None:
            prof, state["prof"] = state["prof"], None
            _sync()
            prof.__exit__(None, None, None)
            prof.export_chrome_trace(_trace_path(log_dir))

    return hook


def span_ms(fn) -> float:
    """The stream's span from the first to the last of fn's kernels, by CUDA
    events around one call (the host's launch gaps included)."""
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b)


def queued_ms(fn, cycles: int = 10**8) -> float | None:
    """Device ms of one call of fn, by CUDA events with the call queued
    behind a GPU sleep of `cycles` clocks (about 60 ms), so that the host's
    launch gaps do not count; None if the enqueueing outlasted the sleep (a
    call of more kernels than the launch queue holds blocks the host until
    the device drains it). The call is made either way."""
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    slept = torch.cuda.Event()
    torch.cuda._sleep(cycles)
    slept.record()
    a.record()
    fn()
    b.record()
    in_time = not slept.query()
    torch.cuda.synchronize()
    return a.elapsed_time(b) if in_time else None


# device kernel name -> operator class, first match wins
KERNEL_CLASSES = (
    ("hand-written kernels", ("combine_fwd_kernel", "combine_bwd_src_kernel", "combine_bwd_v_kernel",
                              "combine_fwd_tc_kernel", "combine_bwd_src_tc_kernel",
                              "combine_bwd_v_tc_kernel", "bin_kernel", "raster_kernel",
                              "gather_kernel", "conv5_kernel", "conv5_tc_kernel",
                              "fwd_pixel_kernel", "bwd_c_kernel", "bwd_c_gattn_kernel",
                              "fold_kernel", "dg_kernel", "dw_kernel", "dw_tc_kernel",
                              "slice_sum_kernel", "scatter_rows_kernel", "row_count_kernel",
                              "row_scan_kernel", "row_scan_totals_kernel", "row_place_kernel",
                              "segment_sort_kernel")),
    ("collectives (NCCL)", ("nccl",)),
    # cuBLAS's kernels are xmma and cutlass kernels too: a convolution's name
    # says fprop, dgrad or wgrad, implicit_gemm, cudnn or conv
    ("convolutions (cuDNN)", ("cudnn", "implicit_gemm", "fprop", "dgrad", "wgrad", "conv")),
    ("matrix products (cuBLAS)", ("gemm", "gemv", "cublas")),
    ("InstanceNorm statistics (var_mean)", ("WelfordOps",)),
    ("Adam and other foreach ops", ("multi_tensor_apply",)),
    ("reductions", ("reduce_kernel",)),
    ("concatenations", ("CatArray",)),
    ("gathers, scatters, index ops", ("gather", "scatter", "index")),
    ("casts and copies", ("copy", "Memcpy", "Memset")),
    ("pooling and softmax", ("max_pool", "softmax")),
    ("elementwise", ("elementwise",)),
)


# a hand-written kernel's function name as a whole word of the profiler's
# kernel name: dw_kernel is not dw_tc_kernel, gather_kernel not aten's
# vectorized_gather_kernel
_HAND_WRITTEN = {key: re.compile(rf"(?<![A-Za-z_]){key}(?![a-z_])")
                 for key in KERNEL_CLASSES[0][1]}


def kernel_class(name: str) -> str:
    if any(pat.search(name) for pat in _HAND_WRITTEN.values()):
        return KERNEL_CLASSES[0][0]
    return next((label for label, keys in KERNEL_CLASSES[1:] if any(k in name for k in keys)),
                "other")


def hand_written(by_name: dict, n: int) -> dict:
    """Device ms and launches per call or step of each hand-written kernel,
    by its function name as a whole word of the profiler's kernel name (so
    that dw_kernel does not count dw_tc_kernel's launches). by_name: {kernel
    name: [device us, launches]} over n calls or steps."""
    out = {}
    for key, pat in _HAND_WRITTEN.items():
        hits = [v for k, v in by_name.items() if pat.search(k)]
        if hits:
            out[key] = dict(ms=sum(v[0] for v in hits) / n / 1e3, count=sum(v[1] for v in hits) // n)
    return out


def idle_gaps(events, lo: float, hi: float, top: int = 10) -> list:
    """The `top` longest stretches of [lo, hi] in which no device event runs,
    longest first. events: (name, start, end, kind) with kind "device" or
    "host" (times in us). Each gap: dict(start, ms, host, next), host being
    the names of the host events running when the gap opened, outermost
    first (empty if the host was between ops), next the name of the first
    host event that began after it opened (None if none did)."""
    busy = sorted((s, e) for _, s, e, kind in events if kind == "device" and e > lo and s < hi)
    gaps, t = [], lo
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    gaps.sort(key=lambda g: g[0] - g[1])
    host = sorted((s, -e, name) for name, s, e, kind in events if kind == "host")
    starts = [h[0] for h in host]
    out = []
    for start, end in gaps[:top]:
        i = bisect.bisect_right(starts, start)
        running = [name for _, neg_end, name in host[:i] if -neg_end > start]
        out.append(dict(start=start, ms=(end - start) / 1e3, host=running,
                        next=host[i][2] if i < len(host) else None))
    return out


def summarize_region(events, lo: float, hi: float, n: int, gaps: int = 10) -> dict | None:
    """Device time by kernel and operator class of the device events that
    start in [lo, hi] (us), per call or step of the n in that span, the
    share of the span's wall time the device was busy, and its `gaps`
    longest idle stretches (`idle_gaps`). None if no device event starts
    there."""
    by_name: dict = {}
    for name, s, e, kind in events:
        if kind == "device" and lo <= s <= hi:
            acc = by_name.setdefault(name, [0.0, 0])
            acc[0] += e - s
            acc[1] += 1
    if not by_name:
        return None
    total = sum(v[0] for v in by_name.values()) / n / 1e3
    wall = (hi - lo) / n / 1e3
    classes: dict = {}
    class_kernels: dict = {}
    for k, v in by_name.items():
        classes[kernel_class(k)] = classes.get(kernel_class(k), 0.0) + v[0] / n / 1e3
        class_kernels[kernel_class(k)] = class_kernels.get(kernel_class(k), 0) + v[1]
    table = sorted(({"name": k[:90], "ms": v[0] / n / 1e3, "count": v[1] // n}
                    for k, v in by_name.items()), key=lambda r: -r["ms"])
    return dict(device_ms=total, wall_ms=wall, busy_share=total / wall,
                kernels_per_call=sum(v[1] for v in by_name.values()) // n, classes=classes,
                class_kernels={k: v // n for k, v in class_kernels.items()},
                kernels=table[:60], hand_written=hand_written(by_name, n),
                idle_gaps=idle_gaps(events, lo, hi, gaps))


def profile_window(regions: dict, out_dir=None, log=print, top: int = 10) -> dict:
    """Device time by kernel over each region {name: (fn, calls)}, in ONE
    torch.profiler run: the regions are told apart by the time ranges of
    their annotations, each closed after a synchronize. Logs each region's
    busy share, its `top` kernels and its operator classes, and returns
    {region: summarize_region(...)} for the regions with device time. With
    `out_dir`, writes the profiler's table to out_dir/profile.txt (building
    it parses the whole trace into Python objects: about 60 us an event)."""
    from pathlib import Path

    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for region, (fn, n) in regions.items():
            with record_function(region):
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    # the trace's raw events (us from the first): ten times faster to read
    # than prof.events()
    kineto = list(prof.profiler.kineto_results.events())
    t0 = min((e.start_ns() for e in kineto), default=0)
    raw = [(e.name(), (e.start_ns() - t0) / 1e3, (e.end_ns() - t0) / 1e3, e.device_type() == cuda)
           for e in kineto]
    spans = {name: (s, e) for name, s, e, on_dev in raw if name in regions and not on_dev}
    # annotations (these regions, Optimizer.step) are mirrored on the device
    # timeline under the host-side names: they are spans, not kernels; the
    # regions' own annotations are not host work inside them
    host_names = {name for name, _, _, on_dev in raw if not on_dev}
    flat = [(name, s, e, "device" if on_dev else "host") for name, s, e, on_dev in raw
            if not (on_dev and name in host_names) and name not in regions]
    if out_dir is not None:
        Path(out_dir).joinpath("profile.txt").write_text(
            prof.key_averages().table(sort_by="device_time_total", row_limit=80))
    out = {}
    for region, (_, n) in regions.items():
        if region not in spans:
            log(f"  profiler: no span for {region} (not measured)")
            continue
        res = summarize_region(flat, *spans[region], n)
        if res is None:
            log(f"  profiler: no device time reported for {region} (not measured)")
            continue
        total, wall = res["device_ms"], res["wall_ms"]
        log(f"  profiler {region}: device busy {total:.2f} ms of {wall:.2f} ms wall per "
            f"{'call' if region.startswith('hoig_serve') else 'step'} ({total / wall:.0%}), "
            f"{res['kernels_per_call']} device kernels; top kernels:")
        for row in res["kernels"][:top]:
            log(f"    {row['ms']:8.3f} ms  x{row['count']:<5d} {row['name']}")
        log("    by operator class: " + "; ".join(
            f"{label} {ms:.2f} ms ({ms / total:.0%})"
            for label, ms in sorted(res["classes"].items(), key=lambda kv: -kv[1])))
        out[region] = res
    return out
