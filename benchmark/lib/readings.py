"""What the metric readers share: the traced stretch's device time by
kernel family, and the model FLOPs and kernel bounds of a run's cell."""

from __future__ import annotations

import json
import sys
from pathlib import Path

from benchmark.lib import flops, roofline, trace

KERNELS = json.loads((Path(__file__).resolve().parents[1] / "metrics" / "kernels.json").read_text())
HAND = dict(zip(KERNELS["hand_written"], trace.whole_word(KERNELS["hand_written"])))


def traced(run):
    """(device events, lo, hi) of the traced stretch, or None."""
    if run.events is None or run.events.get("span") is None:
        return None
    lo, hi = run.events["span"]
    return run.events["device"], lo, hi


def hand_written_us(kernels: dict) -> dict:
    """{hand-written function name: device us} from {kernel name: us}."""
    out: dict = {}
    for name, us in kernels.items():
        for key, pat in HAND.items():
            if pat.search(name):
                out[key] = out.get(key, 0.0) + us
                break
    return out


def conv_us(kernels: dict) -> float:
    """Device us of the convolution kernels (by the data file's name
    patterns), hand-written kernels left out."""
    return sum(us for name, us in kernels.items()
               if not any(p.search(name) for p in HAND.values())
               and any(k in name for k in KERNELS["convolutions"]))


def model_flops(run) -> float:
    return flops.model_flops(run.cfg, run.engine, run.batch, run.kind)


def roofline_pct(run):
    """The hand-written kernels' least time over their device time in the
    traced stretch, in % (the rasterizer left out of both: it has no bound).
    None where a hand-written kernel ran that no bounded wrapper launches:
    a share over part of the kernels would read high."""
    got = traced(run)
    if got is None or run.traced_units == 0:
        return None
    dev, lo, hi = got
    spent = {k: us for k, us in hand_written_us(trace.by_kernel(dev, lo, hi)).items()
             if us > 0 and k not in roofline.UNBOUNDED}
    bounds = roofline.bounds(run.cfg, run.batch, run.kind, run.f_max, run.engine)
    unbounded = set(spent) - {k for w in bounds for k in roofline.KERNELS[w]}
    if unbounded:
        print(f"roofline: no bound for {sorted(unbounded)}; not reported", file=sys.stderr)
        return None
    ran = [w for w in bounds if any(k in spent for k in roofline.KERNELS[w])]
    if not ran:
        return None
    least = sum(bounds[w] for w in ran) * run.traced_units * 1e6
    return 100.0 * least / sum(spent.values())


def idle_pct(run):
    got = traced(run)
    if got is None:
        return None
    dev, lo, hi = got
    return 100.0 * (1.0 - trace.busy_us(dev, lo, hi) / (hi - lo))


def mfu_pct(run, units: int):
    """Model FLOPs of the window's steps or calls over its wall time, as a
    share of the H100's dense bf16 peak."""
    if not run.on_card or not run.loop.window_s:
        return None
    return 100.0 * model_flops(run) * units / run.loop.window_s / roofline.PEAK_BF16_FLOPS
