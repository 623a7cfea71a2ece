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
"""

from __future__ import annotations

import contextlib
import os
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
