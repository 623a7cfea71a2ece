"""The comparison that decides `correct` rejects its control and the faults
a cell can have, at a tiny size on the CPU, with the limits the cells run
under: the reference one precision step down in the program's place (fp8
networks, bf16 conditioning), a step that leaves the state unchanged, half
of each batch left out (the mean over the rest), an answer altered where it
is produced. Each run is a whole run with the timed path broken underneath."""

import pytest
import torch

from benchmark.calibrate import half_batch
from benchmark.lib import harness
from benchmark.lib.program import Program
from benchmark.tests.conftest import CELLS, TINY

SEED = 97


def run(cell, **kw):
    return harness.run_cell(cell, SEED, 0.1, False, "cpu", overrides=TINY, **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_refused(cell):
    result = run(cell, control=True)
    limits = {k: c["limit"] for k, c in result["checks"].items()}
    assert any(not result["control"][k]["value"] <= lim for k, lim in limits.items()), result["control"]


@pytest.mark.parametrize("cell", [c for c in CELLS if "train" in c])
def test_a_step_that_leaves_the_state_unchanged_is_refused(cell, monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    result = run(cell)
    assert not result["correct"] and result["checks"]["update_norm_gap"]["value"] >= 1.0


@pytest.mark.parametrize("cell", CELLS)
def test_half_the_batch_left_out_is_refused(cell, monkeypatch):
    """Each batch's second half replaced by its first: every output keeps
    its shape, so the gaps are finite; in training the gradient numbers
    alone refuse it."""
    step, serve = Program.step, Program.serve
    monkeypatch.setattr(Program, "step", lambda self, b: step(self, half_batch(b)))
    monkeypatch.setattr(Program, "serve", lambda self, b: serve(self, half_batch(b)))
    result = run(cell)
    checks = result["checks"]
    assert not result["correct"]
    assert all(c["value"] < float("inf") for c in checks.values()), checks
    if "train" in cell:
        assert any(checks[k]["value"] > checks[k]["limit"]
                   for k in ("grad_norm_gap_median", "update_norm_gap")), checks


def test_an_altered_answer_is_refused(monkeypatch):
    serve = Program.serve

    def altered(self, b):
        flow, outs = serve(self, b)
        return flow, (outs[0], outs[1] + 0.05) + tuple(outs[2:])

    monkeypatch.setattr(Program, "serve", altered)
    result = run("dexycb.serve_b16")
    assert not result["correct"] and result["checks"]["image_gap"]["value"] > 0.01
