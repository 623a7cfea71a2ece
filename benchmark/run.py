#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the card it starts on.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: correct,
attempted, failed, metrics (the cell's end-to-end metrics, or with
--trace 1 its per-layer ones), device, with --trace 1 a breakdown, and last
the checks (each number compared with its limit), which also end standard
error. Exits non-zero with no result where CUDA or enough cards are
missing, or where JAX or the JAX package was imported.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    from benchmark.lib import harness

    started = harness.process_start()
    import torch

    bench = harness.load_json(ROOT / "BENCHMARK.json")
    chips = harness.find_cell(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        harness.log(f"{args.workload} needs {chips} CUDA device(s); "
                    f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              "cuda", bench=bench, started=started)
    seen = result.pop("forbidden_modules")
    if seen:
        harness.log(f"the process imported {', '.join(seen)}: no result")
        return 3
    harness.print_checks(result["checks"], result.get("readings"))
    print(harness.result_line(result), flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())
