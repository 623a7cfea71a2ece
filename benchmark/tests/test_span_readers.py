"""The readers of the program's spans (`lib/spans.py`) and the metrics that
use them, on made-up host and device events and span records; None from
every reader where the program recorded no span; and a rehearsal of the
float32 training cell on the CPU at a tiny size."""

import json

import pytest
from benchmark.tests.conftest import ROOT, TINY

from benchmark.lib import harness, spans

SEED = 2**31 + 4321
NEW = ("train.conditioning_ms", "train.generator_fwd_ms", "train.g_losses_ms",
       "train.g_backward_ms", "train.d_step_ms", "train.adam_ms", "train.host_enqueue_ms",
       "train.launches_per_step", "serve.host_dispatch_ms", "serve.conditioning_launches",
       "serve.generator_launches", "serve.attention_ms", "serve.idle_in_program_pct")

HOST = [("hoig/train_step", 0, 100), ("aten::mm", 5, 8), ("hoig/conditioning", 10, 40),
        ("cudaLaunchKernel", 12, 13), ("cudaLaunchKernelExC", 30, 31),
        ("cudaMemsetAsync", 50, 51), ("cudaStreamSynchronize", 60, 70),
        ("cudaLaunchKernel", 120, 121), ("hoig/train_step", 200, 260),
        ("hoig/conditioning", 205, 215), ("cuLaunchKernel", 210, 211)]
DEVICE = [("k", 15, 45), ("k", 60, 90), ("k", 130, 140), ("k", 215, 300)]
RECORDS = [dict(name="train_step", stream_ms=5.0), dict(name="conditioning", stream_ms=1.0),
           dict(name="g_adam", stream_ms=0.25), dict(name="train_step", stream_ms=6.0),
           dict(name="conditioning", stream_ms=2.0), dict(name="d_adam", stream_ms=0.5)]


class _Run:
    def __init__(self, host=HOST, device=DEVICE, units=2):
        self.events = dict(span=(0.0, 300.0), host=list(host), device=list(device))
        self.traced_units = units


@pytest.fixture
def recorded(monkeypatch):
    from hoig_torch.utils import profiling

    monkeypatch.setattr(profiling, "spans", lambda: [dict(r) for r in RECORDS])


def test_readers_on_made_up_events(recorded):
    run = _Run()
    assert spans.stream_ms(run, "conditioning") == 1.5
    assert spans.stream_ms(run, "g_adam", "d_adam") == 0.375
    assert spans.stream_ms(run, "attention") is None  # no such span
    assert spans.host_ms(run, "train_step") == pytest.approx(0.08)
    assert spans.host_ms(run, "train_step", "conditioning") == pytest.approx(0.08)  # nested once
    assert spans.host_ms(run, "conditioning") == pytest.approx(0.02)
    # 12, 30, 50 and 210 start inside a step; the sync is no launch, 120 is outside
    assert spans.launches(run, "train_step") == 2
    assert spans.launches(run, "conditioning") == 1.5
    # gaps (start, us): (0, 15), (45, 15), (90, 40) open inside a span; (140, 75) outside
    assert spans.idle_in_program_pct(run) == pytest.approx(100 * 70 / 145)


def test_the_metrics_read_the_spans(recorded):
    run = _Run()
    got = {n: harness.metric_reader(n)(run) for n in NEW}
    assert got["train.conditioning_ms"] == 1.5 and got["train.adam_ms"] == 0.375
    assert got["train.host_enqueue_ms"] == pytest.approx(0.08)
    assert got["train.launches_per_step"] == 2
    assert got["serve.conditioning_launches"] == 1.5
    assert got["serve.host_dispatch_ms"] == pytest.approx(0.02)  # conditioning alone here
    assert got["serve.idle_in_program_pct"] == pytest.approx(100 * 70 / 145)
    for name in ("train.generator_fwd_ms", "train.g_losses_ms", "train.g_backward_ms",
                 "train.d_step_ms", "serve.generator_launches", "serve.attention_ms"):
        assert got[name] is None, name  # those spans are not in the made-up records


@pytest.mark.parametrize("how", ["no records", "no spans function", "untraced"])
def test_no_span_no_metric(monkeypatch, how):
    """A program without spans (the parent of the spans' commit) leaves
    every new metric out of the line, and nothing raises."""
    from hoig_torch.utils import profiling

    run = _Run(host=[h for h in HOST if not h[0].startswith("hoig/")])
    if how == "no records":
        monkeypatch.setattr(profiling, "spans", lambda: [])
    elif how == "no spans function":
        monkeypatch.delattr(profiling, "spans")
    else:
        run.events = None
    assert {n: harness.metric_reader(n)(run) for n in NEW} == {n: None for n in NEW}


def test_every_new_metric_is_an_entry_with_its_cells():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in bench["per_layer"]}
    trains = [w["name"] for w in bench["workloads"] if w["traffic"] == "train_b32"]
    for name in NEW:
        m = entries[name]
        assert m["source"] == "program_span" and m["better"] == "lower"
        want = trains if name.startswith("train.") else ["dexycb.serve_b16"]
        assert sorted(m["workloads"]) == sorted(want), name


def test_float32_cell_rehearsal():
    """The float32 cell at a tiny size on the CPU: its files are found, the
    port runs float32 with full remat on the gather engine, and it agrees
    with the plain reference (no TF32 on the CPU)."""
    result = harness.run_cell("ho3dv3.train_fp32_b32", SEED, 0.2, False, "cpu",
                              overrides=dict(TINY))
    assert result.pop("forbidden_modules") == []
    assert set(result["metrics"]) == {"setup_s", "train_images_per_s"}
    assert result["correct"] and result["attempted"] >= 1
    nums = dict({k: v["value"] for k, v in result["checks"].items()}, **result["readings"])
    assert nums["cond_gap"] < 1e-5 and nums["image_gap"] < 1e-4
    assert nums["grad_norm_gap"] < 1e-3 and nums["loss_rel"] < 5e-3
