#!/usr/bin/env python3
"""`calibrate.py` with its control one precision step below float32, for a
configuration that states float32: the reference's network operands
rounded to bf16 (the gradient passes straight through, as it does through
calibrate.py's fp8 rounding, which is one step below bf16) and the
conditioning's projected vertices to bf16, as calibrate.py's control has
them. Same arguments and output as calibrate.py.

    python3 benchmark/calibrate_below.py --workload ho3dv3.train_fp32_b32 --seeds 7 \\
        --control-seeds 7
"""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


class Bf16Operands:
    """A `Precision` whose operands are rounded to bf16."""

    name = "bf16 networks, bf16 conditioning"
    lower = True

    def operand(self, x):
        from benchmark.reference.precision import bf16_round

        return x + (bf16_round(x.detach()) - x.detach())

    def geometry(self, x):
        from benchmark.reference.precision import bf16_round

        return bf16_round(x)


def main(argv=None) -> int:
    sys.path.insert(0, str(ROOT))
    from benchmark import calibrate
    from benchmark.reference import precision

    precision.LOWER = Bf16Operands()
    return calibrate.main(argv)


if __name__ == "__main__":
    sys.exit(main())
