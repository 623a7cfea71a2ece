"""On the card: one short run of a cell through `benchmark/run.py`, in its
own process, as the benchmark's driver runs it."""

import json
import subprocess
import sys

import pytest

from benchmark.tests.conftest import ROOT


@pytest.mark.card
def test_a_short_serving_run_on_the_card(card):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "dexycb.serve_b16",
                          "--seed", "4242", "--seconds", "3", "--trace", "0"],
                         capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert set(line["metrics"]) == {"setup_s", "serve_images_per_s", "serve_call_p95_ms"}
