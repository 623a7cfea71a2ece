#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path on one NVIDIA GPU.

    python3 chip_smoke.py [--out DIR]     # from the root of a checkout, one card

Phases (any failure exits non-zero, nothing falls back to the CPU):
  1. the card's name and power limit, torch and CUDA versions;
  2. build the hand-written kernels from hoig_torch/csrc (one nvcc each, in
     parallel) and report the build seconds;
  3. drive the serving path once (conditioning + generator_spade_attn at full
     width, 256 px, batch 4, bf16, shift engine, random weights from a seed)
     with every launch counter at 0, and record the inputs each kernel got;
     then hold each kernel against its plain PyTorch version on exactly those
     inputs and time kernel, plain version, library yardstick and bound;
     and hold them again on small ragged shapes off the tile grid;
  4. compare the card with the CPU: the conditioning at 128 px, batch 2, and
     the full-width generator in f32 (TF32 off) at 128 px, batch 1;
  5. time the serving call (>= 5 calls after warm-up), assert 18 / 1 / 2
     launches of the combine / rasterizer / gather kernels per call and
     finite outputs; a short profiler window splits device time by kernel;
  6. print the kernels line, the card line and, last, the result line.

Details (result.json, profile.txt) go to --out, by default build/chip_smoke/.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, FP32 non-tensor FLOP/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
# source of each kernel and the TPU kernel it replaces
KERNELS = {
    "local_combine": ("hoig_torch/csrc/local_combine.cu", "hoig_tpu/ops/local_combine.py:50"),
    "rasterizer": ("hoig_torch/csrc/rasterizer.cu", "hoig_tpu/ops/rasterizer_pallas.py:45"),
    "table_gather": ("hoig_torch/csrc/table_gather.cu", "hoig_tpu/ops/table_gather.py:77"),
}
LAUNCHES_PER_CALL = {"local_combine": 18, "rasterizer": 1, "table_gather": 2}
IMAGE, BATCH = 256, 4


def log(*a):
    print(*a, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def device_ms(fn, reps: int = 10, behind_sleep: bool = True) -> float:
    """Median device time of one call of fn, by CUDA events around each call.

    behind_sleep: queue the calls behind a GPU sleep that outlasts the host's
    work of enqueueing them (checked, and the sleep doubled until it does),
    so that the events time the device alone and not the host's launch gaps.
    The plain versions launch more kernels per call than the launch queue
    holds; they are timed without the sleep (their kernels are large enough
    at these shapes to keep the device busy)."""
    import torch

    fn()
    torch.cuda.synchronize()
    cycles = 10**8 if behind_sleep else 0
    while True:
        marks = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                 for _ in range(reps)]
        slept = torch.cuda.Event()
        if cycles:
            torch.cuda._sleep(cycles)
        slept.record()
        for a, b in marks:
            a.record()
            fn()
            b.record()
        queued_in_time = not cycles or not slept.query()
        torch.cuda.synchronize()
        if queued_in_time:
            return statistics.median(a.elapsed_time(b) for a, b in marks)
        check(cycles < 10**11, "could not queue the timed calls ahead of the device")
        cycles *= 2


class Recorder:
    """Wraps the kernel wrappers at their call sites and keeps their inputs."""

    def __init__(self):
        self.calls = {name: [] for name in KERNELS}

    def wrap(self, name, fn):
        def recorded(*args, **kwargs):
            self.calls[name].append((args, kwargs))
            return fn(*args, **kwargs)
        return recorded


@contextlib.contextmanager
def recording(rec: Recorder):
    import hoig_torch.geometry.conditioning as cond
    import hoig_torch.geometry.renderer as rend
    import hoig_torch.models.generator as gen
    import hoig_torch.ops.rasterizer_cuda as rc

    sites = [(gen, "local_combine", "local_combine"),
             (cond, "rasterize_fim_wim_auto", "rasterizer"),
             (rc, "gather_rows", "table_gather"),
             (rend, "gather_rows", "table_gather")]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in sites]
    for mod, attr, name in sites:
        setattr(mod, attr, rec.wrap(name, getattr(mod, attr)))
    try:
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_local_combine(calls) -> dict:
    """B1 on the 18 recorded (src_pad, v, R) calls: bf16 as recorded, and the
    same inputs in f32. The kernel repeats the plain loop's order and
    rounding, so both are expected to agree exactly."""
    import torch

    from hoig_torch.ops.local_combine import local_combine, local_combine_reference

    rows, err32, err16 = [], 0.0, 0.0
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, bytes=0.0, flops=0.0)
    for (src, v, radius), _ in calls:
        out = local_combine(src, v, radius)
        ref = local_combine_reference(src, v, radius)
        e16 = max_err(out, ref)
        check(torch.allclose(out.float(), ref.float(), atol=1e-2, rtol=1e-2),
              f"local_combine bf16 disagrees: {e16}")
        s32, v32 = src.float(), v.float()
        e32 = max_err(local_combine(s32, v32, radius), local_combine_reference(s32, v32, radius))
        check(e32 <= 1e-5, f"local_combine f32 disagrees: {e32}")
        err16, err32 = max(err16, e16), max(err32, e32)
        b, h, w, c = out.shape
        k2 = (2 * radius + 1) ** 2
        nbytes = (src.numel() + b * h * w * k2 + out.numel()) * src.element_size()
        flops = 2.0 * b * h * w * c * k2
        ms = device_ms(lambda: local_combine(src, v, radius))
        plain = device_ms(lambda: local_combine_reference(src, v, radius), reps=3,
                          behind_sleep=False)
        bnd, by = bound_ms(nbytes, flops)
        rows.append(dict(shape=list(src.shape), radius=radius, dtype=str(src.dtype), ms=ms,
                         plain_ms=plain, bound_ms=bnd, bound_by=by, err_bf16=e16, err_f32=e32))
        for k, val in (("ms", ms), ("plain_ms", plain), ("bound_ms", bnd), ("bytes", nbytes),
                       ("flops", flops)):
            tot[k] += val
    _, by = bound_ms(tot["bytes"], tot["flops"])
    log(f"  local_combine: {len(calls)} calls, max err bf16 {err16:.3g} (atol/rtol 1e-2), "
        f"f32 {err32:.3g} (atol 1e-5)")
    for r in rows:
        log(f"    {r['shape']} R={r['radius']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.3f} ms,"
            f" bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    return dict(max_abs_err=max(err16, err32), ms=tot["ms"], plain_ms=tot["plain_ms"],
                bound_ms=tot["bound_ms"], bound_by=by, library_ms=None, detail=rows)


def _bbox_pairs(bbox, s: int) -> float:
    """(pixel, face) pairs whose pixel centre lies in the face's box: the
    candidate tests this scene needs."""
    import torch

    lo = torch.ceil((bbox[..., 0::2] * s + s - 1) / 2).clamp(0, s)
    hi = torch.floor((bbox[..., 1::2] * s + s - 1) / 2).clamp(-1, s - 1)
    n = (hi - lo + 1).clamp_min(0)
    return float((n[..., 0] * n[..., 1]).sum())


def check_rasterizer(calls) -> dict:
    """B2 on the recorded 2B x 256^2 scene: the z-buffer kernel against the
    plain chunked reduction (indices equal), and the whole fim/wim/rows entry
    against the plain rasterizer (fim and rows equal, wim atol 1e-4)."""
    import torch

    from hoig_torch.ops.rasterizer import _face_setup, rasterize_fim_wim, zbuffer_reference
    from hoig_torch.ops.rasterizer_cuda import face_bbox, rasterize_fim_wim_auto, rasterize_zbuffer

    (fv, valid), kw = calls[0]
    s, near, far, attrs = kw["image_size"], kw["near"], kw["far"], kw["attrs"]
    setup = _face_setup(fv, valid, s)
    bbox = face_bbox(fv, setup["keep"])
    idx = rasterize_zbuffer(setup, bbox, s, near, far)
    idx_ref = zbuffer_reference(setup, s, near, far)
    n_diff = int((idx != idx_ref).sum())
    check(n_diff == 0, f"rasterizer z-buffer disagrees on {n_diff} pixels")
    fim, wim, rows = rasterize_fim_wim_auto(fv, valid, image_size=s, near=near, far=far, attrs=attrs)
    fim_r, wim_r, rows_r = rasterize_fim_wim(fv, valid, image_size=s, near=near, far=far, attrs=attrs)
    check(torch.equal(fim, fim_r) and torch.equal(rows, rows_r), "rasterizer fim/rows disagree")
    e_wim = max_err(wim, wim_r)
    check(e_wim <= 1e-4, f"rasterizer wim disagrees: {e_wim}")
    hits = int((fim >= 0).sum())
    b, f = valid.shape
    nbytes = b * f * 16 * 4 + b * s * s * 4
    pairs = _bbox_pairs(bbox, s)
    flops = pairs * 16  # 3 edge planes + 1 depth plane, 2 mul + 2 add each
    ms = device_ms(lambda: rasterize_zbuffer(setup, bbox, s, near, far))
    plain = device_ms(lambda: zbuffer_reference(setup, s, near, far), reps=3, behind_sleep=False)
    bnd, by = bound_ms(nbytes, flops)
    log(f"  rasterizer: faces {tuple(valid.shape)}, {s}^2, hit pixels {hits}, box pairs {pairs:.4g},"
        f" idx diffs 0, wim err {e_wim:.3g}; kernel {ms:.4f} ms, plain {plain:.3f} ms,"
        f" bound {bnd:.5f} ms ({by})")
    return dict(max_abs_err=e_wim, ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                library_ms=None, detail=dict(hits=hits, box_pairs=pairs))


def check_table_gather(calls) -> dict:
    """B3 on the two recorded calls: bit-equal to take_along_dim."""
    import torch

    from hoig_torch.ops.table_gather import gather_rows, gather_rows_reference

    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0.0)
    for (table, idx), _ in calls:
        out = gather_rows(table, idx)
        check(torch.equal(out, gather_rows_reference(table, idx)), "table_gather not bit-equal")
        idx64 = idx.long()[..., None]
        b, r, a = table.shape
        p = idx.shape[1]
        tot["bytes"] += b * p * 4 + table.numel() * 4 + b * a * p * 4
        tot["ms"] += device_ms(lambda: gather_rows(table, idx))
        tot["plain_ms"] += device_ms(lambda: gather_rows_reference(table, idx).contiguous())
        tot["library_ms"] += device_ms(lambda: torch.take_along_dim(table, idx64, dim=1))
        log(f"    table {tuple(table.shape)}, idx {tuple(idx.shape)}")
    bnd, by = bound_ms(tot["bytes"], 0.0)
    log(f"  table_gather: {len(calls)} calls bit-equal; kernel {tot['ms']:.4f} ms, plain "
        f"{tot['plain_ms']:.4f} ms, take_along_dim {tot['library_ms']:.4f} ms, bound {bnd:.4f} ms")
    return dict(max_abs_err=0.0, ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=bnd,
                bound_by=by, library_ms=tot["library_ms"])


def check_ragged_shapes() -> None:
    """Each kernel against its plain version on small shapes its wrapper
    takes but the main path does not give it: partial pixel tiles and
    channel chunks, extra coefficient columns, an image size off the tile
    grid, a partial face chunk, a narrow table."""
    import torch

    from hoig_torch.ops.local_combine import local_combine, local_combine_reference
    from hoig_torch.ops.rasterizer import rasterize_fim_wim
    from hoig_torch.ops.rasterizer_cuda import rasterize_fim_wim_auto
    from hoig_torch.ops.table_gather import gather_rows, gather_rows_reference

    gen = torch.Generator(device="cuda").manual_seed(5)
    randn = lambda *shape: torch.randn(*shape, device="cuda", generator=gen)
    for dtype in (torch.float32, torch.bfloat16):
        for b, h, w, c, r, extra in ((2, 13, 11, 6, 3, 15), (1, 9, 20, 70, 5, 0)):
            src = randn(b, h + 2 * r, w + 2 * r, c).to(dtype)
            v = randn(b, h, w, (2 * r + 1) ** 2 + extra).to(dtype)
            check(torch.equal(local_combine(src, v, r), local_combine_reference(src, v, r)),
                  f"local_combine differs at {tuple(src.shape)} R={r} {dtype}")
    fv = randn(2, 300, 3, 3) * 0.4
    fv[..., 2] = fv[..., 2].abs() + 1.5
    valid = torch.rand(2, 300, device="cuda", generator=gen) > 0.1
    fim, wim = rasterize_fim_wim_auto(fv, valid, image_size=100)
    fim_r, wim_r = rasterize_fim_wim(fv, valid, image_size=100)
    check(torch.equal(fim, fim_r) and max_err(wim, wim_r) <= 1e-4,
          "rasterizer differs on the 100 px random scene")
    table = randn(3, 77, 3)
    idx = torch.randint(0, 77, (3, 1000), device="cuda", generator=gen, dtype=torch.int32)
    check(torch.equal(gather_rows(table, idx), gather_rows_reference(table, idx)),
          "table_gather differs on a (3, 77, 3) table")
    log(f"  ragged shapes: all three kernels equal their plain versions "
        f"(100 px scene: {int((fim >= 0).sum())} hit pixels)")


def compare_with_cpu() -> dict:
    """The card against the CPU's plain path on the same inputs and weights."""
    import torch

    from hoig_torch.data.synthetic import synthetic_batch, synthetic_environment
    from hoig_torch.geometry.conditioning import ConditioningConfig
    from hoig_torch.train.model_api import batch_as_torch, flow_only
    from hoig_torch.train.trainer import TrainConfig, build_generator, generator_kwargs

    s = 128
    env_cpu = synthetic_environment(2, s, device="cpu")
    env_gpu = dict(env_cpu, tables=env_cpu["tables_np"].as_torch("cuda"),
                   mano_params=env_cpu["mano"].as_torch("cuda"))
    batch = synthetic_batch(2, env_cpu["obj_verts"], image_size=s, seed=3)
    ccfg = ConditioningConfig(image_size=s)
    fc = flow_only(batch_as_torch(batch, "cpu"), env_cpu, ccfg)
    fg = flow_only(batch_as_torch(batch, "cuda"), env_gpu, ccfg)
    exact = ("src_crop_mask_bg", "tsf_crop_mask_bg", "src_crop_mask_hand", "tsf_crop_mask_hand")
    worst = 0.0
    for k, v in fc.items():
        if v is None:
            continue
        g = fg[k].cpu()
        if k in exact:
            check(torch.equal(g, v), f"conditioning {k} differs between card and CPU")
        else:
            # elements off by > 1e-4: z-fights between nearly coplanar faces
            share = float(((g - v).abs() > 1e-4).float().mean())
            check(share <= 1e-3, f"conditioning {k}: {share:.3g} of elements differ > 1e-4")
            worst = max(worst, share)
    log(f"  conditioning 128 px b2: masks equal, share of other elements off by >1e-4: {worst:.3g}")

    tcfg = TrainConfig(conv_dim=64, repeat_num=6, corner_engine="shift",
                    compute_dtype=torch.float32)
    g_cpu = build_generator(tcfg, device="cpu", seed=1)
    g_gpu = copy.deepcopy(g_cpu).to(device="cuda", memory_format=torch.channels_last)
    kw = generator_kwargs({k: (None if v is None else v[:1]) for k, v in fc.items()},
                          torch.as_tensor(batch["maskA"][:1]), torch.as_tensor(batch["maskB"][:1]),
                          True)
    with torch.inference_mode():
        t0 = time.perf_counter()
        out_c = g_cpu(**kw)
        cpu_s = time.perf_counter() - t0
        out_g = g_gpu(**{k: (None if v is None else v.cuda()) for k, v in kw.items()})
    err = max(max_err(a.cpu(), b) for a, b in zip(out_g, out_c))
    # f32 on both sides, TF32 off; the ~45 stacked convolutions and norms run
    # other summation orders on the card
    check(err <= 1e-3, f"full-width generator card vs CPU max abs err {err}")
    log(f"  generator f32 conv_dim 64 repeat 6, 128 px b1: card vs CPU max abs err {err:.3g} "
        f"(tol 1e-3); CPU forward {cpu_s:.1f} s")
    return dict(conditioning_share_off=worst, generator_err=err)


def profile_window(gen, batch, env, ccfg, tcfg, out_dir: Path) -> dict:
    """Device time by kernel over two serving calls (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from hoig_torch.train.model_api import flow_only, forward_only

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            forward_only(gen, flow_only(batch, env, ccfg), batch, tcfg)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if getattr(e, "device_time_total", 0) > 0
              and e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        log("  profiler: no device time reported (not measured)")
        return {}
    events.sort(key=lambda e: e.device_time_total, reverse=True)
    total = sum(e.device_time_total for e in events)
    table = [dict(name=e.key[:90], ms_per_call=e.device_time_total / 2e3, count=e.count // 2)
             for e in events]
    (out_dir / "profile.txt").write_text(
        prof.key_averages().table(sort_by="device_time_total", row_limit=60))
    log(f"  profiler: device busy {total / 2e3:.2f} ms per call; top kernels:")
    for row in table[:12]:
        log(f"    {row['ms_per_call']:8.3f} ms  x{row['count']:<4d} {row['name']}")
    return dict(device_ms_per_call=total / 2e3, kernels=table[:40])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=REPO / "build" / "chip_smoke",
                    help="directory for result.json and profile.txt")
    out_dir = ap.parse_args().out
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the GPU path only", file=sys.stderr)
        return 2
    if not (REPO / "hoig_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository (hoig_torch/ missing)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    out_dir.mkdir(parents=True, exist_ok=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    from hoig_torch.data.synthetic import synthetic_batch, synthetic_environment
    from hoig_torch.geometry.conditioning import ConditioningConfig
    from hoig_torch.ops import _cuda
    from hoig_torch.train.environment import resolve_corner_engine
    from hoig_torch.train.model_api import batch_as_torch, flow_only, forward_only
    from hoig_torch.train.trainer import TrainConfig, build_generator

    # 1. the card
    card = card_line()
    log(f"[1] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # 2. build
    t0 = time.perf_counter()
    report = _cuda.build_all()
    build_s = time.perf_counter() - t0
    for name, text in report.items():
        lines = [ln.strip() for ln in text.splitlines() if "registers" in ln or "smem" in ln]
        log(f"  {name}: " + ("; ".join(lines[-4:]) if lines else text.strip()[:200]))
    log(f"[2] kernels built in {build_s:.1f} s")

    # 3. main path once, counters from 0, kernel inputs recorded
    t0 = time.perf_counter()
    env = synthetic_environment(2, IMAGE, device="cuda")
    log(f"[3] synthetic environment {IMAGE} px built in {time.perf_counter() - t0:.1f} s "
        f"(faces {tuple(env['tables_np'].faces.shape)})")
    ccfg = ConditioningConfig(image_size=IMAGE)
    tcfg = TrainConfig(conv_dim=64, repeat_num=6,
                       corner_engine=resolve_corner_engine("auto", bf16=True),
                       compute_dtype=torch.bfloat16)
    check(tcfg.corner_engine == "shift", "bf16 must pick the shift engine")
    gen = build_generator(tcfg, device="cuda", seed=0)
    batch = batch_as_torch(synthetic_batch(BATCH, env["obj_verts"], image_size=IMAGE), "cuda")
    rec = Recorder()
    with recording(rec):
        torch.cuda.synchronize()
        _cuda.reset_launch_counts()
        outs = forward_only(gen, flow_only(batch, env, ccfg), batch, tcfg)
        torch.cuda.synchronize()
        launches = _cuda.launch_counts()
    log(f"  main path launches: {launches}")
    for name, n in LAUNCHES_PER_CALL.items():
        check(launches.get(name, 0) == n, f"{name}: {launches.get(name, 0)} launches, expected {n}")
        check(len(rec.calls[name]) == n, f"{name}: {len(rec.calls[name])} calls recorded")
    check(all(torch.isfinite(o).all() for o in outs), "non-finite serving outputs")
    results = {
        "local_combine": check_local_combine(rec.calls["local_combine"]),
        "rasterizer": check_rasterizer(rec.calls["rasterizer"]),
        "table_gather": check_table_gather(rec.calls["table_gather"]),
    }
    del rec
    check_ragged_shapes()

    # 4. card against CPU
    log("[4] card vs CPU")
    cpu_cmp = compare_with_cpu()

    # 5. timing at 256 px, batch 4, bf16
    log(f"[5] serving call timing: {IMAGE} px, batch {BATCH}, bf16, shift engine, conv_dim 64, "
        "repeat 6")
    for _ in range(2):
        forward_only(gen, flow_only(batch, env, ccfg), batch, tcfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cond_ms, gen_ms = [], []
    for _ in range(7):
        _cuda.reset_launch_counts()
        t0 = time.perf_counter()
        flow = flow_only(batch, env, ccfg)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        outs = forward_only(gen, flow, batch, tcfg)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        check(_cuda.launch_counts() == LAUNCHES_PER_CALL,
              f"per-call launches {_cuda.launch_counts()} != {LAUNCHES_PER_CALL}")
        check(all(torch.isfinite(o).all() for o in outs), "non-finite serving outputs")
        cond_ms.append((t1 - t0) * 1e3)
        gen_ms.append((t2 - t1) * 1e3)
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    total = [a + b for a, b in zip(cond_ms, gen_ms)]
    serve = dict(conditioning_ms=statistics.median(cond_ms), generator_ms=statistics.median(gen_ms),
                 call_ms=statistics.median(total),
                 images_per_s=BATCH / (statistics.median(total) / 1e3),
                 peak_mem_mb=peak_mb, calls=len(total), cond_ms_all=cond_ms, gen_ms_all=gen_ms)
    log(f"  conditioning {serve['conditioning_ms']:.2f} ms, generator {serve['generator_ms']:.2f} ms,"
        f" call {serve['call_ms']:.2f} ms, {serve['images_per_s']:.2f} images/s, peak "
        f"{peak_mb:.0f} MiB (median of {len(total)})")

    profile = profile_window(gen, batch, env, ccfg, tcfg, out_dir)

    # 6. report
    kernels = []
    for name, (src, replaces) in KERNELS.items():
        r = results[name]
        kernels.append(dict(name=name, route="cuda", source=src, replaces=replaces,
                            launches=launches[name], max_abs_err=r["max_abs_err"], ms=r["ms"],
                            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                            library_ms=r["library_ms"]))
    detail = dict(card=card, torch=torch.__version__, cuda=torch.version.cuda, build_s=build_s,
                  kernels=results, cpu_compare=cpu_cmp, serving=serve, profile=profile)
    (out_dir / "result.json").write_text(json.dumps(detail, indent=1, default=str))
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
