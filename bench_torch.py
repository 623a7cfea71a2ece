#!/usr/bin/env python3
"""Throughput benchmark of the PyTorch/CUDA port: 256x256 HOGAN on one
NVIDIA GPU, one JSON line on stdout (the counterpart of bench.py, which
times the JAX package).

Headline metric: full GAN train-step images/sec/chip at 256x256 in the
flagship configuration (generator_spade_attn, conv_dim 64, repeat 6, SPADE
and the 9 flow-guided attention layers, PatchGAN-4, the full loss set with
the VGG19 loss, the conditioning inside the step), bf16 with the bf16 remat
defaults (remat on, the bottleneck's and the attention's activations kept)
and the corner engine resolve_corner_engine picks under bf16 (shift): what
train_config_from_opt builds for --bf16. Batch 4, the reference's per-GPU
batch. Synthetic environment and batch (hoig_torch.data.synthetic), weights
random from seeds: G 0, D 1, VGG19 2.

The legs, each in its own process, the headline first:
  train_bf16         the headline;
  gen_fwd            the serving call: flow_only + forward_only (composite
                     included) under no_grad in the headline's
                     configuration, each call's imageA the previous fake;
  train_bf16_b8      the headline at batch 8;
  train_bf16_dexycb  the DexYCB variant: fx/fy camera, PCA-45 MANO without
                     the flat hand mean, bg_dim 13, img_cond_dim 9, a
                     24-channel D input, no masks, no arm mask;
  train_fp32         TrainConfig() as it stands: f32, full remat, the gather
                     engine (the reference's own training precision).

vs_baseline: the reference publishes no throughput (BASELINE.md). The
denominator is an ESTIMATE of the PyTorch reference on an A100, derived,
not measured, as

    est. A100 img/s = (TF32 peak 156 TFLOP/s x 30% utilization)
                      / (3 x generator-forward FLOPs per image)

(forward + backward: 3x the forward). It is FROZEN at A100_EST_IMG_S =
16.25, bench.py's first derivation, so that the ratio compares across runs;
no card measured it. The gen_fwd leg re-derives it from the port's FLOP
walk, as a diagnostic only.

Timing integrity (bench.py's rules): steps chain through the state (Adam
updates G and D in place, so step i+1 reads step i's weights; serving calls
chain through the fake); a timed loop ends in torch.cuda.synchronize() and
a .item() of one metric; the reported time is the difference of a 2k-step
and a k-step loop, best of 2 each, so that the constant start and end cost
cancels; per-step-synchronized steps (min of 3) cross-check it, and a
pipelined time below blocked / 2.2 raises before anything is printed, as
does a share of peak of 100% or more. The kernels are built
(hoig_torch.ops._cuda.build_all) before the first step, and the build's
seconds and the first step's are recorded apart.

Share of peak: the FLOP walk's executed FLOPs (hoig_torch/utils/flops.py:
the model FLOPs, remat's recompute and the tensor-core kernels' extra bf16
passes) per second, over the H100 SXM data sheet's dense bf16 tensor-core
peak (989 TFLOP/s) for the bf16 legs and its TF32 peak (494.7) for the fp32
leg, whose convolutions cuDNN runs in TF32 by torch's default (the JSON
records the TF32 flags; nothing here changes them).

    python bench_torch.py                                # every leg
    HOIG_BENCH_HEADLINE_ONLY=1 python bench_torch.py     # the headline alone
    HOIG_BENCH_HEADLINE_ONLY=1 HOIG_BENCH_ENGINE=pallas python bench_torch.py

Environment: HOIG_BENCH_ENGINE=auto|shift|gather|pallas, the bf16 legs'
corner engine (auto: shift; the fp32 leg keeps gather);
HOIG_BENCH_HEADLINE_ONLY=1; HOIG_BENCH_BUDGET_S, the wall-clock budget of
the diagnostic legs (default 2700); HOIG_BENCH_LEG, internal: run one leg
and print its details. Details go to --out (default build/bench_torch/):
BENCH_DETAILS.json in full mode, one JSON line appended to BENCH_AB.json per
headline-only run. It runs on the card; --device cpu with a small
--image_size / --conv_dim / --repeat_num / --batch / --iters rehearses it without one
(no device number; the JSON names every setting off the flagship's).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

A100_TF32_PEAK = 156e12  # dense TF32 FLOP/s (A100 80GB data sheet)
A100_UTILIZATION = 0.30  # a generous estimate for the eager torch reference
# FROZEN vs_baseline denominator (see the module docstring)
A100_EST_IMG_S = 16.25

METRIC = "hogan_train_step_images_per_sec_per_chip_256_bf16"
DIAG_LEGS = ("gen_fwd", "train_bf16_b8", "train_bf16_dexycb", "train_fp32")
# a pipelined time below the blocked one / TIMING_RATIO is a timing artifact,
# and so is a b4 / b8 per-image throughput ratio outside 1 / TIMING_RATIO ..
# TIMING_RATIO
TIMING_RATIO = 2.2
# the flagship's settings; a run off them says so in its JSON
FLAGSHIP = dict(device="cuda", image_size=256, conv_dim=64, repeat_num=6, batch=4, iters=10)


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=str(REPO / "build" / "bench_torch"),
                   help="directory for BENCH_DETAILS.json and BENCH_AB.json")
    p.add_argument("--device", default=FLAGSHIP["device"], help="'cuda' (the default) or 'cpu'")
    p.add_argument("--image_size", type=int, default=FLAGSHIP["image_size"])
    p.add_argument("--conv_dim", type=int, default=FLAGSHIP["conv_dim"])
    p.add_argument("--repeat_num", type=int, default=FLAGSHIP["repeat_num"])
    p.add_argument("--batch", type=int, default=FLAGSHIP["batch"],
                   help="the batch of every leg but train_bf16_b8, which runs twice it")
    p.add_argument("--iters", type=int, default=FLAGSHIP["iters"],
                   help="k: the timed loops run k and 2k steps or calls")
    opts = p.parse_args(argv)
    # the flags as given, passed on to each leg's process
    opts.argv = list(sys.argv[1:] if argv is None else argv)
    return opts


def rehearsal(opts) -> dict | None:
    """The settings off the flagship's, or None."""
    off = {k: getattr(opts, k) for k, v in FLAGSHIP.items() if getattr(opts, k) != v}
    return off or None


def headline_line(value: float, rehearsal_: dict | None) -> dict:
    line = {"metric": METRIC, "value": round(value, 3), "unit": "images/sec/chip",
            "vs_baseline": round(value / A100_EST_IMG_S, 3)}
    if rehearsal_:
        line["rehearsal"] = rehearsal_
    return line


def main(argv=None):
    # bench.py's HOIG_BENCH_XLA_FLAGS has no counterpart: the port has no XLA
    opts = parse_args(argv)
    leg = os.environ.get("HOIG_BENCH_LEG")
    headline_only = os.environ.get("HOIG_BENCH_HEADLINE_ONLY") == "1"
    if leg is None and not headline_only:
        # full mode: one subprocess per leg, so that a leg past the budget
        # can be killed; the headline's line is printed when it returns
        return orchestrate(opts)
    return worker(leg or "train_bf16", headline_only, opts)


# ------------------------------------------------------------------ the legs


def leg_spec(leg: str, engine: str = "shift", image_size: int = 256, conv_dim: int = 64,
             repeat_num: int = 6, batch: int = 4) -> dict:
    """One leg's program: dict(kind "train" or "serve", batch, tcfg, ccfg,
    camera, with_masks). `engine` is the bf16 legs' corner engine."""
    import torch

    from hoig_torch.geometry.conditioning import ConditioningConfig
    from hoig_torch.train.trainer import TrainConfig

    size = dict(image_size=image_size, conv_dim=conv_dim, repeat_num=repeat_num)
    # the bf16 remat defaults (train_config_from_opt under --bf16)
    bf16 = dict(compute_dtype=torch.bfloat16, remat_bottleneck=False, remat_attn=False,
                corner_engine=engine)
    spec = dict(kind="train", batch=batch, tcfg=TrainConfig(**size, **bf16),
                ccfg=ConditioningConfig(image_size=image_size), camera="matrix", with_masks=True)
    if leg == "gen_fwd":
        spec["kind"] = "serve"
    elif leg == "train_bf16_b8":
        # batch 8 per card: 4 cards x 8 is the reference's global batch 32
        spec["batch"] = 2 * batch
    elif leg == "train_bf16_dexycb":
        # the DexYCB widths of train_config_from_opt (HOIG_DexYCB/models/trainer.py:263-270)
        spec.update(
            tcfg=TrainConfig(**size, bg_dim=13, img_cond_dim=9, d_input_nc=24, use_armask=False,
                             **bf16),
            ccfg=ConditioningConfig(image_size=image_size, camera_model="fxfy",
                                    mano_pca_comps=45, mano_flat_hand_mean=False),
            camera="fxfy", with_masks=False)
    elif leg == "train_fp32":
        spec["tcfg"] = TrainConfig(**size)
    elif leg != "train_bf16":
        raise SystemExit(f"unknown HOIG_BENCH_LEG {leg!r}")
    return spec


def expected_launches(spec: dict) -> dict:
    """The kernel launches per step (per call for gen_fwd) that the FLOP walk
    expects: its attention kernels, plus the conditioning's one rasterizer
    call and two table gathers, the InstanceNorm kernels
    (flops.instance_norm_launches) and, in a training step, the attention's
    edge-pad folds (flops.edge_pad_folds) and the gather engine's corner
    scatters (flops.scatter_rows_launches)."""
    from hoig_torch.utils import flops

    tcfg, kind = spec["tcfg"], spec["kind"]
    walk = flops.kernel_launches(tcfg, spec["batch"], kind)
    out = dict({k: len(v) for k, v in walk.items()}, rasterizer=1, table_gather=2,
               **flops.instance_norm_launches(tcfg, kind))
    for name, n in (("edge_pad_fold", flops.edge_pad_folds(tcfg, kind)),
                    ("scatter_rows", flops.scatter_rows_launches(tcfg, kind))):
        if n:
            out[name] = n
    return out


def blocked_ms(run, finish, n: int = 3) -> float:
    """The fastest of n runs, each one synchronized: an upper bound on the
    true time, immune to queued work."""
    best = math.inf
    for _ in range(n):
        t0 = time.perf_counter()
        finish(run())
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def pipelined_ms(run, finish, k: int) -> float:
    """ms per run from the difference of a 2k-run and a k-run loop (best of 2
    each, one synchronization at each loop's end)."""
    def loop(n):
        best = math.inf
        for _ in range(2):
            t0 = time.perf_counter()
            for _ in range(n):
                out = run()
            finish(out)
            best = min(best, time.perf_counter() - t0)
        return best

    t1 = loop(k)
    t2 = loop(2 * k)
    return max(t2 - t1, 1e-9) / k * 1e3


def check_timing(tag: str, ms: float, blocked: float) -> None:
    """The pipelined loop may only be modestly faster than synchronized
    steps (the host's dispatch overlapping the device), never TIMING_RATIO x."""
    if ms < blocked / TIMING_RATIO:
        raise RuntimeError(f"{tag}: TIMING ARTIFACT: the pipelined loop measured {ms:.2f} ms "
                           f"but a synchronized one {blocked:.2f} ms; refusing to report")


def share_of_peak(tag: str, flops_: float, ms: float, peak: float) -> float:
    share = flops_ / (ms / 1e3) / peak
    if share >= 1.0:
        raise RuntimeError(f"{tag}: IMPOSSIBLE share of peak {share:.1%}: a timing artifact; "
                           "refusing to report")
    return share


def worker(leg: str, headline_only: bool, opts=None):
    opts = opts or parse_args([])
    import torch

    sys.path.insert(0, str(REPO / "scripts"))
    from profile_step_torch import card_line

    from hoig_torch.data.synthetic import synthetic_batch, synthetic_environment
    from hoig_torch.models.vgg import init_vgg
    from hoig_torch.ops import _cuda
    from hoig_torch.train.environment import resolve_corner_engine
    from hoig_torch.train.model_api import batch_as_torch, flow_only, forward_only
    from hoig_torch.train.trainer import (build_generator, build_networks, init_state,
                                          make_train_step)
    from hoig_torch.utils import flops

    device = _cuda.resolve_device(opts.device)
    on_card = device.type == "cuda"
    engine = resolve_corner_engine(os.environ.get("HOIG_BENCH_ENGINE", "auto"), bf16=True)
    s = opts.image_size
    details = dict(image_size=s, conv_dim=opts.conv_dim, repeat_num=opts.repeat_num, n_chips=1,
                   iters=opts.iters, corner_engine=engine,
                   device=torch.cuda.get_device_name(0) if on_card else "cpu",
                   card=card_line() if on_card else None, torch=torch.__version__,
                   cuda=torch.version.cuda,
                   tf32=dict(cudnn=torch.backends.cudnn.allow_tf32,
                             matmul=torch.backends.cuda.matmul.allow_tf32))
    if rehearsal(opts):
        details["rehearsal"] = rehearsal(opts)
    tag = "train_bf16" if headline_only else leg
    spec = leg_spec(tag, engine, s, opts.conv_dim, opts.repeat_num, opts.batch)

    t0 = time.perf_counter()
    if on_card:
        _cuda.build_all()
    details[f"{tag}_kernel_build_s"] = time.perf_counter() - t0
    env = synthetic_environment(2, s, device=device)
    batch = batch_as_torch(synthetic_batch(spec["batch"], env["obj_verts"], image_size=s,
                                           camera=spec["camera"], with_masks=spec["with_masks"]),
                           device)

    def finish(metric):
        if on_card:
            torch.cuda.synchronize()
        metric.item()

    def measure(run):
        """Time `run` (one chained step or call returning a device scalar)
        and record the leg's numbers under `tag`."""
        _cuda.reset_launch_counts()
        t0 = time.perf_counter()
        finish(run())
        details[f"{tag}_first_step_s"] = time.perf_counter() - t0
        first = _cuda.launch_counts()
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        _cuda.reset_launch_counts()
        blocked = blocked_ms(run, finish)
        # one launch count per kernel launch: over the 3 synchronized steps; a
        # serving call after the first replays its CUDA graphs, which runs no
        # wrapper, so a call's are the first (eager) call's
        counts = {k: v // 3 if v % 3 == 0 else v / 3 for k, v in _cuda.launch_counts().items()}
        if spec["kind"] == "serve":
            counts = first
        ms = pipelined_ms(run, finish, opts.iters)
        check_timing(tag, ms, blocked)
        b, tcfg = spec["batch"], spec["tcfg"]
        walk = flops.leg_flops(tcfg, b, spec["kind"])["total"]
        if tcfg.compute_dtype == torch.bfloat16:
            peak, peak_label = flops.PEAK_BF16_TC_FLOPS, "H100 SXM dense bf16 tensor cores"
        else:
            peak, peak_label = flops.PEAK_TF32_TC_FLOPS, "H100 SXM dense TF32 tensor cores"
        peak_label += f", {peak / 1e12:g} TFLOP/s"
        share = share_of_peak(tag, walk["executed"], ms, peak)
        unit = "step_ms" if spec["kind"] == "train" else "ms"
        details.update({
            f"{tag}_batch": b,
            f"{tag}_images_per_sec_per_chip": b / (ms / 1e3),
            f"{tag}_{unit}": ms,
            f"{tag}_{unit}_blocked": blocked,
            f"{tag}_flops_executed": walk["executed"],
            f"{tag}_flops_model": walk["model"],
            f"{tag}_launches_walk": expected_launches(spec),
            f"{tag}_device": torch.cuda.get_device_name() if on_card else "cpu",
            # device numbers: none from a run on the CPU
            f"{tag}_tflops_per_sec": walk["executed"] / (ms / 1e3) / 1e12 if on_card else None,
            f"{tag}_mfu": share if on_card else None,
            f"{tag}_mfu_peak": peak_label,
            f"{tag}_launches": counts if on_card else None,
            f"{tag}_peak_mem_mib": torch.cuda.max_memory_allocated() / 2**20 if on_card else None,
        })
        log(f"{tag}: {details[f'{tag}_images_per_sec_per_chip']:.3f} img/s/chip ({ms:.2f} ms, "
            f"synchronized {blocked:.2f} ms)"
            + (f", {share:.2%} of the {peak_label} peak" if on_card else ", on the CPU"))
        return details[f"{tag}_images_per_sec_per_chip"]

    if spec["kind"] == "serve":
        tcfg = spec["tcfg"]
        gen = build_generator(tcfg, device=device, seed=0)
        chain = {"imageA": batch["imageA"]}

        @torch.no_grad()
        def call():
            # call i + 1's source image is call i's fake, NCHW
            b_ = dict(batch, imageA=chain["imageA"])
            fake = forward_only(gen, flow_only(b_, env, spec["ccfg"]), b_, tcfg)[0]
            chain["imageA"] = fake.permute(0, 3, 1, 2).to(batch["imageA"].dtype).contiguous()
            return fake.reshape(-1)[0]

        value = measure(call)
        per_image = flops.leg_flops(tcfg, spec["batch"], "serve")["total"]["model"] / spec["batch"]
        details["gen_fwd_flops_per_image"] = per_image
        # the A100 estimate re-derived from the walk: a diagnostic only (the
        # vs_baseline denominator stays FROZEN)
        details["baseline_estimate"] = {"a100_img_s_rederived_diagnostic":
                                        A100_TF32_PEAK * A100_UTILIZATION / (3.0 * per_image)}
    else:
        tcfg = spec["tcfg"]
        state = init_state(*build_networks(tcfg, device=device, seed=0), tcfg)
        vgg = init_vgg(seed=2, compute_dtype=tcfg.compute_dtype, device=device)
        step = make_train_step(vgg, env["tables"], env["mano_params"], spec["ccfg"], tcfg)
        value = measure(lambda: step(state, batch, True)[1]["loss_G"])

    if headline_only:
        # an A/B run: the headline alone, appended to BENCH_AB.json (never
        # over a full run's BENCH_DETAILS.json)
        out = Path(opts.out)
        out.mkdir(parents=True, exist_ok=True)
        with open(out / "BENCH_AB.json", "a") as fp:
            fp.write(json.dumps(details) + "\n")
        print(json.dumps(headline_line(value, details.get("rehearsal"))), flush=True)
        log(json.dumps(details, indent=1))
        return
    print("LEGDETAILS " + json.dumps(details), flush=True)


# -------------------------------------------------------------- orchestrator


def orchestrate(opts=None):
    """Full mode: one subprocess per leg, the headline first.

    The orchestrator imports no torch and holds no card: a diagnostic leg
    that outlasts the rest of HOIG_BENCH_BUDGET_S is killed and recorded as
    skipped, so the run ends shortly after the budget however a leg hangs.

    bench.py retried a timed-out headline once under HOIG_COMPILE_LITE (XLA
    fallback kernels). The port has no fallback kernels and adds none: a
    headline that fails or times out exits non-zero and prints no number."""
    opts = opts or parse_args([])
    budget_s = float(os.environ.get("HOIG_BENCH_BUDGET_S", "2700"))
    t_start = time.time()
    out = Path(opts.out)
    out.mkdir(parents=True, exist_ok=True)
    details: dict = {}

    def flush_details():
        (out / "BENCH_DETAILS.json").write_text(json.dumps(details, indent=1))

    def run_leg(name: str, timeout: float) -> bool:
        env = dict(os.environ, HOIG_BENCH_LEG=name)
        t0 = time.time()
        try:
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), *opts.argv],
                                  env=env, stdout=subprocess.PIPE, text=True, timeout=timeout)
        except subprocess.TimeoutExpired:
            log(f"{name}: leg killed after {timeout:.0f} s (budget): skipped")
            details.setdefault("legs_skipped_for_budget", []).append(name)
            return False
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("LEGDETAILS ")]
        if proc.returncode != 0 or not lines:
            log(f"{name}: leg exited rc={proc.returncode}"
                + ("" if lines else " with no details"))
            details.setdefault("legs_failed", []).append(name)
            return False
        leg_details = json.loads(lines[0][len("LEGDETAILS "):])
        # nested merge: gen_fwd's re-derived estimate must not clobber the
        # FROZEN denominator's entry
        details.setdefault("baseline_estimate", {}).update(
            leg_details.pop("baseline_estimate", {}))
        details.update(leg_details)
        details[f"{name}_wall_s"] = time.time() - t0
        return True

    ok = run_leg("train_bf16", max(budget_s, 600.0))
    value = details.get("train_bf16_images_per_sec_per_chip")
    if not ok or not value:
        flush_details()
        raise SystemExit("headline train_bf16 leg failed")
    details["baseline_estimate"].update(
        a100_train_img_s_per_gpu_FROZEN=A100_EST_IMG_S,
        derivation="156e12 TF32 peak * 0.30 utilization / (3 * generator-forward FLOPs per "
                   "image), frozen at bench.py's first derivation; an estimate, no card measured "
                   "it; the reference publishes no throughput")
    flush_details()
    print(json.dumps(headline_line(value, details.get("rehearsal"))), flush=True)

    for name in DIAG_LEGS:
        remaining = budget_s - (time.time() - t_start)
        if remaining < 60.0:
            log(f"{name}: SKIPPED: the diagnostic budget is spent ({remaining:.0f} s left of "
                f"{budget_s:.0f} s)")
            details.setdefault("legs_skipped_for_budget", []).append(name)
            continue
        run_leg(name, remaining)
        flush_details()

    # cross-batch sanity: the per-image throughput of b4 and b8 agree within
    # TIMING_RATIO. The port's eager step is host-bound at both batches, so
    # b8's per-image throughput is about twice b4's and this flag is raised
    # whenever the b8 step measures 9% faster than the b4 step; the step
    # times are in the message
    b8 = details.get("train_bf16_b8_images_per_sec_per_chip")
    if b8:
        ratio = value / b8
        if not 1 / TIMING_RATIO < ratio < TIMING_RATIO:
            details["SANITY_FAIL_b4_vs_b8"] = (
                f"per-image throughput disagrees {1 / ratio:.2f}x between b4 ({value:.2f}) and "
                f"b8 ({b8:.2f} img/s), steps of {details.get('train_bf16_step_ms', 0):.1f} and "
                f"{details.get('train_bf16_b8_step_ms', 0):.1f} ms: one of the legs is a timing "
                "artifact, or the step does not grow with the batch")
            log("SANITY FAIL: " + details["SANITY_FAIL_b4_vs_b8"])
    fp32 = details.get("train_fp32_images_per_sec_per_chip")
    if fp32:
        details["bf16_speedup"] = value / fp32
    for what in ("kernel_build_s", "first_step_s"):
        details[f"{what}_total"] = sum(v for k, v in details.items() if k.endswith("_" + what))
    flush_details()
    log(json.dumps(details, indent=1))


if __name__ == "__main__":
    main()
