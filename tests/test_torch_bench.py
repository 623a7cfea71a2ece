"""bench_torch.py, the port's benchmark, on the CPU (torch only; the
counterpart of tests/test_bench_orchestrator.py).

The orchestrator is tested with a faked subprocess layer: the headline's
line is printed the moment the headline leg returns, a failed or timed-out
headline prints no number and is not retried, diagnostic legs are killed or
skipped at the budget, the b4-vs-b8 sanity flag is raised, and gen_fwd's
re-derived baseline does not clobber the frozen one. Each of the five legs
then runs through `worker` at the rehearsal size (48 px: PatchGAN-4's
smallest, conv_dim 8, repeat 2, batch 1, k = 1), its FLOP numerator held to
the walk, and the two refusals (a pipelined time far below the synchronized
one, a share of peak of 100% or more) are driven by faked times."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import bench_torch  # noqa: E402
from hoig_torch.data.synthetic import synthetic_batch, synthetic_environment  # noqa: E402
from hoig_torch.models.vgg import init_vgg  # noqa: E402
from hoig_torch.train import trainer  # noqa: E402
from hoig_torch.train.model_api import batch_as_torch  # noqa: E402
from hoig_torch.train.trainer import build_networks, init_state, make_train_step  # noqa: E402
from hoig_torch.utils import flops  # noqa: E402

torch.set_num_threads(1)

SMALL = ["--device", "cpu", "--image_size", "48", "--conv_dim", "8", "--repeat_num", "2",
         "--batch", "1", "--iters", "1"]


# ------------------------------------------------- the orchestrator, faked


class FakeProc:
    def __init__(self, stdout, returncode=0):
        self.stdout = stdout
        self.returncode = returncode


def _leg_output(name, extra=None):
    d = {f"{name}_images_per_sec_per_chip": 15.0, f"{name}_step_ms": 266.5,
         f"{name}_first_step_s": 3.0, f"{name}_kernel_build_s": 0.5}
    d.update(extra or {})
    return "noise\nLEGDETAILS " + json.dumps(d) + "\n"


def _orchestrate(monkeypatch, tmp_path, fake_run, budget="2700"):
    monkeypatch.chdir(tmp_path)  # nothing may land in the working directory
    monkeypatch.setenv("HOIG_BENCH_BUDGET_S", budget)
    monkeypatch.setattr(subprocess, "run", fake_run)
    out = tmp_path / "out"
    try:
        bench_torch.orchestrate(bench_torch.parse_args(["--out", str(out)]))
    finally:
        assert sorted(p.name for p in tmp_path.iterdir()) == ["out"]
    return json.loads((out / "BENCH_DETAILS.json").read_text())


def _json_lines(text):
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


def test_happy_path_merges_legs_and_prints_headline_first(monkeypatch, tmp_path, capsys):
    calls, seen = [], {}

    def fake_run(cmd, env=None, stdout=None, text=None, timeout=None):
        name = env["HOIG_BENCH_LEG"]
        calls.append(name)
        assert cmd[1:] == [str(ROOT / "bench_torch.py"), "--out", str(tmp_path / "out")]
        # the headline's line is out before any diagnostic leg starts
        seen[name] = _json_lines(capsys.readouterr().out)
        return FakeProc(_leg_output(name))

    details = _orchestrate(monkeypatch, tmp_path, fake_run)
    assert calls == ["train_bf16", *bench_torch.DIAG_LEGS]
    assert seen["train_bf16"] == []
    assert seen["gen_fwd"] == [{"metric": bench_torch.METRIC, "value": 15.0,
                                "unit": "images/sec/chip",
                                "vs_baseline": round(15.0 / bench_torch.A100_EST_IMG_S, 3)}]
    assert _json_lines(capsys.readouterr().out) == []  # nothing after the headline
    for name in calls:
        assert details[f"{name}_step_ms"] == 266.5 and f"{name}_wall_s" in details
    assert details["first_step_s_total"] == pytest.approx(15.0)
    assert details["kernel_build_s_total"] == pytest.approx(2.5)
    assert details["bf16_speedup"] == 1.0
    assert not {"legs_failed", "legs_skipped_for_budget", "SANITY_FAIL_b4_vs_b8"} & set(details)


def test_gen_fwd_rederived_baseline_keeps_the_frozen_one(monkeypatch, tmp_path):
    def fake_run(cmd, env=None, stdout=None, text=None, timeout=None):
        name = env["HOIG_BENCH_LEG"]
        extra = ({"baseline_estimate": {"a100_img_s_rederived_diagnostic": 17.2}}
                 if name == "gen_fwd" else None)
        return FakeProc(_leg_output(name, extra))

    be = _orchestrate(monkeypatch, tmp_path, fake_run)["baseline_estimate"]
    assert be["a100_train_img_s_per_gpu_FROZEN"] == bench_torch.A100_EST_IMG_S == 16.25
    assert be["a100_img_s_rederived_diagnostic"] == 17.2


@pytest.mark.parametrize("how", ["timeout", "crash", "no_details"])
def test_headline_failure_exits_nonzero_without_a_number(monkeypatch, tmp_path, capsys, how):
    calls = []

    def fake_run(cmd, env=None, stdout=None, text=None, timeout=None):
        calls.append((env["HOIG_BENCH_LEG"], env.get("HOIG_COMPILE_LITE"), timeout))
        if how == "timeout":
            raise subprocess.TimeoutExpired(cmd, timeout)
        if how == "crash":
            return FakeProc(_leg_output(env["HOIG_BENCH_LEG"]), returncode=1)
        return FakeProc("Traceback ...\n", returncode=1)

    with pytest.raises(SystemExit, match="headline"):
        _orchestrate(monkeypatch, tmp_path, fake_run)
    # no fallback retry, no fabricated number
    assert calls == [("train_bf16", None, 2700.0)]
    assert _json_lines(capsys.readouterr().out) == []


@pytest.mark.parametrize("budget", ["2700", "30"])
def test_diagnostic_legs_skipped_once_the_budget_is_spent(monkeypatch, tmp_path, budget):
    """With budget left, each diagnostic leg starts with the rest as its
    timeout and is killed there; with none left (under 60 s), none starts."""
    calls = []

    def fake_run(cmd, env=None, stdout=None, text=None, timeout=None):
        name = env["HOIG_BENCH_LEG"]
        calls.append((name, timeout))
        if name != "train_bf16":
            assert timeout <= float(budget)
            raise subprocess.TimeoutExpired(cmd, timeout)
        return FakeProc(_leg_output(name))

    details = _orchestrate(monkeypatch, tmp_path, fake_run, budget)
    names = [c[0] for c in calls]
    assert names == (["train_bf16", *bench_torch.DIAG_LEGS] if budget == "2700" else ["train_bf16"])
    assert details["legs_skipped_for_budget"] == list(bench_torch.DIAG_LEGS)
    assert "train_bf16_b8_images_per_sec_per_chip" not in details
    assert details["train_bf16_images_per_sec_per_chip"] == 15.0


def test_cross_batch_sanity_flags_disagreement(monkeypatch, tmp_path):
    def fake_run(cmd, env=None, stdout=None, text=None, timeout=None):
        name = env["HOIG_BENCH_LEG"]
        # 40x the per-image throughput of the b4 leg: impossible
        extra = {f"{name}_images_per_sec_per_chip": 600.0} if name == "train_bf16_b8" else None
        return FakeProc(_leg_output(name, extra))

    assert "SANITY_FAIL_b4_vs_b8" in _orchestrate(monkeypatch, tmp_path, fake_run)


def test_a_failed_diagnostic_leg_is_recorded(monkeypatch, tmp_path):
    def fake_run(cmd, env=None, stdout=None, text=None, timeout=None):
        name = env["HOIG_BENCH_LEG"]
        return FakeProc(_leg_output(name), returncode=int(name == "train_fp32"))

    details = _orchestrate(monkeypatch, tmp_path, fake_run)
    assert details["legs_failed"] == ["train_fp32"]


# ----------------------------------------------------- the worker on the CPU


def _run_worker(monkeypatch, capsys, tmp_path, leg, extra=()):
    monkeypatch.setenv("HOIG_BENCH_LEG", leg)
    monkeypatch.delenv("HOIG_BENCH_HEADLINE_ONLY", raising=False)
    monkeypatch.delenv("HOIG_BENCH_ENGINE", raising=False)
    bench_torch.main(SMALL + ["--out", str(tmp_path), *extra])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("LEGDETAILS ")]
    assert len(lines) == 1
    return json.loads(lines[0][len("LEGDETAILS "):])


@pytest.mark.parametrize("leg", ["train_bf16", *bench_torch.DIAG_LEGS])
def test_each_leg_runs_through_the_worker(monkeypatch, capsys, tmp_path, leg):
    """The leg's program runs its first step or call for real; its timed
    loops are stood in by a consistent pair of times (the CPU's wall clock
    under parallel test workers can put any pair past check_timing's
    refusal; blocked_ms and pipelined_ms are held on a fake clock below)."""
    monkeypatch.setattr(bench_torch, "blocked_ms", lambda run, finish: 250.0)
    monkeypatch.setattr(bench_torch, "pipelined_ms", lambda run, finish, k: 200.0)
    details = _run_worker(monkeypatch, capsys, tmp_path, leg)
    spec = bench_torch.leg_spec(leg, "shift", 48, 8, 2, 1)
    train = spec["kind"] == "train"
    unit = "step_ms" if train else "ms"
    assert (details[f"{leg}_{unit}"], details[f"{leg}_{unit}_blocked"]) == (200.0, 250.0)
    for key in ("images_per_sec_per_chip", unit, unit + "_blocked", "first_step_s",
                "kernel_build_s", "flops_executed", "flops_model", "mfu", "mfu_peak",
                "tflops_per_sec", "launches", "launches_walk", "peak_mem_mib", "device", "batch"):
        assert f"{leg}_{key}" in details, key
    assert details[f"{leg}_batch"] == (2 if leg == "train_bf16_b8" else 1)
    assert details[f"{leg}_images_per_sec_per_chip"] == pytest.approx(
        details[f"{leg}_batch"] / details[f"{leg}_{unit}"] * 1e3)
    # the FLOP numerator is the walk's executed count for this leg's program
    walk = flops.leg_flops(spec["tcfg"], spec["batch"], spec["kind"])["total"]
    assert details[f"{leg}_flops_executed"] == walk["executed"]
    assert details[f"{leg}_launches_walk"] == bench_torch.expected_launches(spec)
    # a CPU run gives no device number, and says it was a rehearsal
    assert details["device"] == details[f"{leg}_device"] == "cpu" and details["card"] is None
    for key in ("mfu", "tflops_per_sec", "launches", "peak_mem_mib"):
        assert details[f"{leg}_{key}"] is None, key
    assert details["rehearsal"] == dict(device="cpu", image_size=48, conv_dim=8, repeat_num=2,
                                        batch=1, iters=1)
    assert details["corner_engine"] == "shift"
    assert ("TF32" in details[f"{leg}_mfu_peak"]) == (leg == "train_fp32")
    if leg == "gen_fwd":
        per_image = flops.leg_flops(spec["tcfg"], 1, "serve")["total"]["model"]
        assert details["gen_fwd_flops_per_image"] == per_image
        assert details["baseline_estimate"]["a100_img_s_rederived_diagnostic"] == pytest.approx(
            156e12 * 0.3 / (3 * per_image))
    else:
        assert "baseline_estimate" not in details


class FakeClock:
    """perf_counter for bench_torch: each run() takes `run_s` (the first one
    `first_s` more), each finish() `sync_s`."""

    def __init__(self, run_s, sync_s, first_s=0.0):
        self.t, self.run_s, self.sync_s, self.first_s = 0.0, run_s, sync_s, first_s

    def perf_counter(self):
        return self.t

    def run(self):
        self.t += self.run_s + self.first_s
        self.first_s = 0.0
        return self.t

    def finish(self, _):
        self.t += self.sync_s


@pytest.mark.parametrize("k", [1, 10])
def test_timed_loops_on_a_fake_clock(monkeypatch, k):
    """blocked_ms: the fastest synchronized run (run + sync); pipelined_ms:
    the difference of a 2k-run and a k-run loop over k, best of 2 each, so
    the one synchronization and a slow first run both drop out."""
    clock = FakeClock(run_s=0.007, sync_s=0.003, first_s=0.1)
    monkeypatch.setattr(bench_torch, "time", type("T", (), {"perf_counter": clock.perf_counter}))
    assert bench_torch.blocked_ms(clock.run, clock.finish) == pytest.approx(10.0)
    clock.first_s = 0.1
    assert bench_torch.pipelined_ms(clock.run, clock.finish, k) == pytest.approx(7.0)
    assert clock.t == pytest.approx(2 * 0.1 + 3 * 0.010 + 6 * k * 0.007 + 4 * 0.003)


@pytest.mark.parametrize("fake", ["timing", "share"])
def test_faked_times_are_refused_before_anything_is_printed(monkeypatch, capsys, tmp_path, fake):
    # timing: a pipelined loop 10x faster than synchronized steps; share: a
    # nanosecond a call, far above any peak
    blocked, pipelined = (100.0, 10.0) if fake == "timing" else (1e-6, 1e-6)
    monkeypatch.setattr(bench_torch, "blocked_ms", lambda run, finish: finish(run()) or blocked)
    monkeypatch.setattr(bench_torch, "pipelined_ms", lambda run, finish, k: pipelined)
    with pytest.raises(RuntimeError, match="TIMING ARTIFACT" if fake == "timing" else "IMPOSSIBLE"):
        _run_worker(monkeypatch, capsys, tmp_path, "gen_fwd")
    assert capsys.readouterr().out == ""


def test_headline_only_appends_to_bench_ab(monkeypatch, capsys, tmp_path):
    """HOIG_BENCH_HEADLINE_ONLY=1 times the headline alone (here on faked
    times, after one real step) and appends its details to BENCH_AB.json;
    HOIG_BENCH_ENGINE picks the bf16 legs' engine."""
    monkeypatch.setattr(bench_torch, "blocked_ms", lambda run, finish: 250.0)
    monkeypatch.setattr(bench_torch, "pipelined_ms", lambda run, finish, k: 200.0)
    monkeypatch.setenv("HOIG_BENCH_HEADLINE_ONLY", "1")
    monkeypatch.setenv("HOIG_BENCH_ENGINE", "pallas")
    monkeypatch.delenv("HOIG_BENCH_LEG", raising=False)
    for _ in range(2):
        bench_torch.main(SMALL + ["--out", str(tmp_path)])
    lines = capsys.readouterr().out.splitlines()
    head = json.loads(lines[-1])
    assert head == {"metric": bench_torch.METRIC, "value": 5.0, "unit": "images/sec/chip",
                    "vs_baseline": round(5.0 / 16.25, 3), "rehearsal": dict(
                        device="cpu", image_size=48, conv_dim=8, repeat_num=2, batch=1, iters=1)}
    ab = [json.loads(ln) for ln in (tmp_path / "BENCH_AB.json").read_text().splitlines()]
    assert len(ab) == 2 and ab[0]["corner_engine"] == "pallas"
    assert ab[0]["train_bf16_step_ms"] == 200.0 and ab[0]["train_bf16_step_ms_blocked"] == 250.0
    assert ab[0]["train_bf16_launches_walk"]["attn_fused_fwd_tc"] == 5
    assert not (tmp_path / "BENCH_DETAILS.json").exists()


def test_bench_needs_a_card_unless_told_cpu(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.setenv("HOIG_BENCH_LEG", "train_bf16")
    monkeypatch.delenv("HOIG_BENCH_HEADLINE_ONLY", raising=False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench_torch.main([])


def test_leg_specs_are_bench_py_legs():
    """The legs' programs at the flagship size: bench.py's configurations."""
    specs = {leg: bench_torch.leg_spec(leg) for leg in ("train_bf16", *bench_torch.DIAG_LEGS)}
    head = specs["train_bf16"]["tcfg"]
    assert (head.compute_dtype, head.remat, head.remat_bottleneck, head.remat_attn,
            head.corner_engine, head.image_size, head.conv_dim, head.repeat_num) == (
        torch.bfloat16, True, False, False, "shift", 256, 64, 6)
    assert [specs[k]["batch"] for k in specs] == [4, 4, 8, 4, 4]
    assert specs["gen_fwd"]["kind"] == "serve" and specs["gen_fwd"]["tcfg"] == head
    assert specs["train_bf16_b8"]["tcfg"] == head
    dex = specs["train_bf16_dexycb"]
    assert (dex["tcfg"].bg_dim, dex["tcfg"].img_cond_dim, dex["tcfg"].d_input_nc,
            dex["tcfg"].use_armask) == (13, 9, 24, False)
    assert (dex["ccfg"].camera_model, dex["ccfg"].mano_pca_comps,
            dex["ccfg"].mano_flat_hand_mean) == ("fxfy", 45, False)
    assert (dex["camera"], dex["with_masks"]) == ("fxfy", False)
    assert specs["train_fp32"]["tcfg"] == trainer.TrainConfig()
    # the walk's launches per step: 18 / 18 / 9 per shift step at either
    # batch, and the backward of the attention's 18 edge pads; the
    # InstanceNorm kernels: G's 85 norms and D's 4 a pass (three passes a
    # step), the recompute's apply of the 37 norms of the conv blocks under
    # the bf16 remat defaults (of all 85 under full remat), three kernels a
    # backward for each of the 97
    norms = dict(inorm_stats=97, inorm_apply=97 + 37, inorm_backward=3 * 97)
    shift = dict(local_combine_tc=18, local_combine_bwd_src_tc=18, local_combine_bwd_v_tc=9,
                 rasterizer=1, table_gather=2, edge_pad_fold=18, **norms)
    for leg in ("train_bf16", "train_bf16_b8", "train_bf16_dexycb"):
        assert bench_torch.expected_launches(specs[leg]) == shift
    assert bench_torch.expected_launches(specs["gen_fwd"]) == dict(
        local_combine_tc=18, rasterizer=1, table_gather=2, inorm_stats=85, inorm_apply=85)
    assert bench_torch.expected_launches(specs["train_fp32"]) == dict(
        rasterizer=1, table_gather=2, edge_pad_fold=9, scatter_rows=9,
        **dict(norms, inorm_apply=97 + 85))
    fused = bench_torch.expected_launches(bench_torch.leg_spec("train_bf16", "pallas"))
    assert fused == dict(attn_fused_fwd_tc=9, attn_fused_bwd_c=9, attn_fused_bwd_a_gsrc_tc=9,
                         attn_fused_bwd_a_dw_tc=9, rasterizer=1, table_gather=2, edge_pad_fold=9,
                         **norms)
    with pytest.raises(SystemExit):
        bench_torch.leg_spec("train_bf16_b16")


def test_walk_reads_the_dexycb_widths(monkeypatch):
    """The DexYCB step (shift engine, f32 at 48 px, batch 1) under
    FlopCounterMode counts the walk's executed aten FLOPs: D's first conv
    over 24 channels, the background branch over 13, the hand SPADE over 9;
    the conditioning stood in by its outputs on the same batch."""
    spec = bench_torch.leg_spec("train_bf16_dexycb", "shift", 48, 8, 2, 1)
    cfg = trainer.TrainConfig(**{f: getattr(spec["tcfg"], f) for f in (
        "image_size", "conv_dim", "repeat_num", "bg_dim", "img_cond_dim", "d_input_nc",
        "use_armask", "corner_engine")})
    env = synthetic_environment(2, 48, device="cpu")
    batch = batch_as_torch(synthetic_batch(1, env["obj_verts"], image_size=48, camera="fxfy",
                                           with_masks=False), "cpu")
    flow = trainer._conditioning(env["tables"], env["mano_params"], batch, spec["ccfg"])
    monkeypatch.setattr(trainer, "_conditioning", lambda *a: flow)
    state = init_state(*build_networks(cfg, device="cpu", seed=0), cfg)
    step = make_train_step(init_vgg(seed=2, device="cpu"), env["tables"], env["mano_params"],
                           spec["ccfg"], cfg)
    _, counted = flops.aten_flops(lambda: step(state, batch, True))
    walk = flops.leg_flops(cfg, 1, "train")
    assert counted == sum(v["executed"] for v in walk["aten"].values())
    # against the HOv3 widths: only the first convs of D and of the
    # background branch differ, and the hand branches' SPADE input convs (3
    # in the encoder, 2 in the bottleneck's first half at repeat 2)
    hov3 = flops.step_ops(trainer.TrainConfig(image_size=48, conv_dim=8, repeat_num=2,
                                              corner_engine="shift"), 1)
    dex = flops.step_ops(cfg, 1)
    differ = {k: sum(a != b for a, b in zip(dex[k], hov3[k])) for k in dex}
    assert {k: n for k, n in differ.items() if n} == {
        "bg (ResNet, 2B)": 1, "src hand (ResUnet)": 5, "tsf hand (ResUnet)": 5,
        "D in G's loss (fake)": 1, "D step (real + fake)": 2}
