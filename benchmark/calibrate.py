#!/usr/bin/env python3
"""Readings for the limits of `correct`: one process runs a cell's set-up
and checked steps or calls on many seeds and prints, per seed, the numbers
the comparison holds (the program against the plain reference) and, where
asked, those of the control (the reference one precision step down in the
program's place) and of a planted fault.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 3 ... \\
        [--control-seeds 1 2 3] [--fault half --fault-seeds 1 2 3] [--out DIR]

Faults: "half" trains or serves on each batch with its second half replaced
by its first (half of the batch left out, the mean taken over the rest,
every output at its full size). The window is as short as the checked calls
allow: the numbers come from set-up and the checked work. It runs on the
card; the benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def half_batch(batch: dict) -> dict:
    """The batch with its second half replaced by its first: every output
    keeps its shape, and a mean over the rows is the mean over the first
    half alone."""
    n = batch["imageA"].shape[0]
    h = n // 2

    def halve(v):
        idx = torch.arange(n, device=v.device) % h
        return v.index_select(0, idx)

    return {k: ({kk: halve(vv) for kk, vv in v.items()} if isinstance(v, dict) else halve(v))
            for k, v in batch.items()}


def plant(fault: str):
    """Break the program underneath the harness; returns the undo."""
    from benchmark.lib.program import Program

    saved = {k: getattr(Program, k) for k in ("step", "serve")}
    if fault == "half":
        Program.step = lambda self, b: saved["step"](self, half_batch(b))
        Program.serve = lambda self, b: saved["serve"](self, half_batch(b))
    else:
        raise SystemExit(f"unknown fault {fault!r}")

    def undo():
        for k, v in saved.items():
            setattr(Program, k, v)
    return undo


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault", default=None)
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--reference-rows", type=int, default=None,
                   help="the reference's rows per block, in place of the mix's")
    p.add_argument("--out", default=str(ROOT / "chiprun_out" / "calibrate"))
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark.lib import harness

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    sink = open(out / f"{args.workload}.jsonl", "a")

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        sink.write(line + "\n")
        sink.flush()

    overrides = {} if args.reference_rows is None else {"reference_rows": args.reference_rows}
    runs = [(s, "program") for s in args.seeds]
    runs += [(s, "fault") for s in args.fault_seeds if args.fault]
    for seed, what in runs:
        t0 = time.time()
        undo = plant(args.fault) if what == "fault" else None
        try:
            res = harness.run_cell(args.workload, seed, 0.0, False, "cuda", overrides=overrides,
                                   control=what == "program" and seed in args.control_seeds,
                                   detail=True)
        finally:
            if undo:
                undo()
        emit(dict(workload=args.workload, seed=seed, reference_rows=args.reference_rows,
                  run=what if what == "program" else args.fault,
                  numbers=dict({k: v["value"] for k, v in res["checks"].items()},
                               **res.get("readings", {})),
                  control={k: v["value"] for k, v in res.get("control", {}).items()} or None,
                  detail=res.get("detail"), setup_s=res["metrics"]["setup_s"]["value"],
                  seconds=time.time() - t0,
                  peak=res["device"]["memory_peak_bytes"]))
    sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
