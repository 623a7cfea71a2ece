"""The one general traffic generator: closed loops over a pool of seeded rows.

A traffic mix is a data file (`benchmark/traffic/<name>.json`) whose
parameters this module reads:
  kind             "train" (chained training steps) or "serve" (serving calls);
  batch            rows per step or call;
  pool_batches     the pool's size in batches (rows do not repeat within a pass);
  checked_steps    (train) the first steps, run in set-up, that the
                   reference follows;
  warmup_calls     (serve) calls made in set-up, untimed;
  checked_calls, checked_from_first
                   (serve) how many calls of the window the reference
                   checks, drawn from the seed among its first calls;
  traced_steps / traced_calls
                   steps or calls profiled after the window of a traced run;
  reference_rows   rows per block of the reference.
One client sends the next step or call once the last has returned (a
training step returns at once, so steps queue on the device until the
window's end synchronizes); a serving call returns when its image is
synchronized. A mix with any other key is refused (`check`): the
generator would not send what it says.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.lib import inputs


KEYS = {"train": {"kind", "batch", "pool_batches", "checked_steps", "traced_steps",
                  "reference_rows"},
        "serve": {"kind", "batch", "pool_batches", "warmup_calls", "checked_calls",
                  "checked_from_first", "traced_calls", "reference_rows"}}


def check(mix: dict) -> None:
    """Raise unless the mix has exactly the keys its kind reads."""
    if mix.get("kind") not in KEYS:
        raise ValueError(f"traffic kind {mix.get('kind')!r}: only {sorted(KEYS)}")
    want = KEYS[mix["kind"]]
    if set(mix) != want:
        raise ValueError(f"a {mix['kind']} mix reads {sorted(want)}; unknown "
                         f"{sorted(set(mix) - want)}, missing {sorted(want - set(mix))}")


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class TrainLoop:
    """Chained training steps at batch `batch`, each on new rows."""

    def __init__(self, mix: dict, program, pool: dict, order, device):
        self.mix, self.program, self.pool, self.order, self.device = mix, program, pool, order, device
        self.checked_rows: list = []
        self.steps = 0
        self.window_s = 0.0

    def one(self):
        return self.program.step(inputs.take(self.pool, self.order()))

    def checked(self, on_first_step=None) -> list:
        """The first steps, whose rows the reference follows: their losses
        (device scalars); `on_first_step` runs after the first."""
        losses = []
        for i in range(self.mix["checked_steps"]):
            rows = self.order()
            self.checked_rows.append(rows.clone())
            m = self.program.step(inputs.take(self.pool, rows))
            losses.append((m["loss_G"], m["loss_D"]))
            if i == 0 and on_first_step is not None:
                on_first_step()
        return losses

    def window(self, seconds: float) -> None:
        _sync(self.device)
        t0 = time.perf_counter()
        n = 0
        while time.perf_counter() - t0 < seconds:
            self.one()
            n += 1
        _sync(self.device)
        self.window_s, self.steps = time.perf_counter() - t0, n

    def traced(self) -> int:
        for _ in range(self.mix["traced_steps"]):
            self.one()
        return self.mix["traced_steps"]


class ServeLoop:
    """Serving calls at batch `batch`, each on new rows, each timed from the
    hand-over of its inputs to its synchronized image."""

    def __init__(self, mix: dict, program, pool: dict, order, device, sample_seed: int):
        self.mix, self.program, self.pool, self.order, self.device = mix, program, pool, order, device
        rng = np.random.RandomState(sample_seed)
        self.sampled = sorted(rng.choice(mix["checked_from_first"], mix["checked_calls"],
                                         replace=False).tolist())
        self.kept: list = []  # (rows, conditioning, outputs) of the sampled calls
        self.latencies_s: list = []
        self.cond_ms: list = []
        self.gen_ms: list = []
        self.calls = 0
        self.window_s = 0.0

    def warmup(self) -> None:
        for _ in range(self.mix["warmup_calls"]):
            self.program.serve(inputs.take(self.pool, self.order()))
        _sync(self.device)

    def window(self, seconds: float, spans: bool = False) -> None:
        """Calls until `seconds` have passed and the sampled calls are done;
        with `spans`, CUDA events time the conditioning and the generator of
        each call."""
        cuda = torch.device(self.device).type == "cuda"
        events = []
        t0 = time.perf_counter()
        n = 0
        while time.perf_counter() - t0 < seconds or n <= self.sampled[-1]:
            rows = self.order()
            batch = inputs.take(self.pool, rows)
            t_in = time.perf_counter()
            if spans and cuda:
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
                ev[0].record()
                flow = self.program.conditioning(batch)
                ev[1].record()
                outs = self.program.generator(flow, batch)
                ev[2].record()
                events.append(ev)
            else:
                flow, outs = self.program.serve(batch)
            _sync(self.device)
            self.latencies_s.append(time.perf_counter() - t_in)
            if n in self.sampled:
                self.kept.append((rows.clone(), {k: None if v is None else v.clone()
                                                 for k, v in flow.items()},
                                  tuple(o.clone() for o in outs)))
            n += 1
        self.window_s, self.calls = time.perf_counter() - t0, n
        for ev in events:
            self.cond_ms.append(ev[0].elapsed_time(ev[1]))
            self.gen_ms.append(ev[1].elapsed_time(ev[2]))

    def traced(self) -> int:
        for _ in range(self.mix["traced_calls"]):
            self.program.serve(inputs.take(self.pool, self.order()))
        return self.mix["traced_calls"]
