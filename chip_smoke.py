#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path and its GAN training step on one
NVIDIA GPU.

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
     the full-width generator in f32 (TF32 off) at 128 px, batch 1, its
     outputs and the gradient of a fixed scalar of them w.r.t. every weight;
  5. time the serving call (>= 5 calls after warm-up), assert 18 / 1 / 2
     launches of the combine / rasterizer / gather kernels per call and
     finite outputs;
  6. the training step (make_train_step: conditioning, generator, G losses
     with VGG and the PatchGAN-4 discriminator, both Adam updates) at full
     width, 256 px, batch 4, bf16, shift engine: one step from launch
     counters at 0 with the backward kernels' inputs recorded, then bwd_src
     and bwd_v held against their plain versions on those inputs (bf16 as
     recorded and f32) and on ragged shapes, and timed; warm and timed steps
     with the per-step launch counts (18 / 18 / 9 / 1 / 2) asserted, finite
     metrics, every weight moved, D bit-equal across a gated step; the same
     again with the bf16 remat defaults for the memory peak;
  7. one profiler window over two serving calls and one training step splits
     the device time of each by kernel;
  8. print the kernels line, the card line and, last, the result line.

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
    "local_combine_bwd_src": ("hoig_torch/csrc/local_combine.cu",
                              "hoig_tpu/ops/local_combine.py:62"),
    "local_combine_bwd_v": ("hoig_torch/csrc/local_combine.cu", "hoig_tpu/ops/local_combine.py:80"),
    "rasterizer": ("hoig_torch/csrc/rasterizer.cu", "hoig_tpu/ops/rasterizer_pallas.py:45"),
    "table_gather": ("hoig_torch/csrc/table_gather.cu", "hoig_tpu/ops/table_gather.py:77"),
}
# launches per serving call, and per training step: each of the 9 attention
# layers combines twice forward; both calls need dsrc, only the second (whose
# coefficients come from the attention, not from the no-grad flow) needs dv
LAUNCHES_PER_CALL = {"local_combine": 18, "rasterizer": 1, "table_gather": 2}
LAUNCHES_PER_STEP = {"local_combine": 18, "local_combine_bwd_src": 18, "local_combine_bwd_v": 9,
                     "rasterizer": 1, "table_gather": 2}
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
        # "local_combine_backward": (src_pad, v, g, R, d_cols, need_src, need_v) of each
        # backward call, the inputs of the bwd_src and bwd_v kernels
        self.calls = {name: [] for name in (*KERNELS, "local_combine_backward")}

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
    import hoig_torch.ops.local_combine as lc
    import hoig_torch.ops.rasterizer_cuda as rc

    sites = [(gen, "local_combine", "local_combine"),
             (lc, "local_combine_backward", "local_combine_backward"),
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


def _dv_close(dv, ref, src, g, dtype_is_bf16: bool) -> tuple[bool, float]:
    """bwd_v sums each channel dot in its own order (ascending channels, fused
    multiply-adds), the plain version in torch.sum's. f32: |err| <= 1e-5 of
    the largest |g[p]| * |src[q]| (the bound of any such dot). bf16: both
    round an f32 dot to bf16, so they differ by at most one bf16 ulp (2^-7 of
    the value) where the f32 sums straddle a rounding boundary."""
    scale = float(g.float().norm(dim=-1).max() * src.float().norm(dim=-1).max())
    err = (dv.float() - ref.float()).abs()
    tol = 1e-5 * scale + (2.0 ** -7 * ref.float().abs() if dtype_is_bf16 else 0.0)
    return bool((err <= tol).all()), float(err.max())


def check_local_combine_backward(calls) -> dict:
    """B1-bwd-src and B1-bwd-v on every recorded backward call, bf16 as
    recorded and the same inputs in f32. bwd_src repeats the plain loop's
    order and rounding and is expected to agree exactly."""
    import torch

    from hoig_torch.ops.local_combine import (local_combine_backward,
                                              local_combine_backward_reference)

    names = ("local_combine_bwd_src", "local_combine_bwd_v")
    tot = {n: dict(ms=0.0, plain_ms=0.0, bytes=0.0, flops=0.0, err=0.0, calls=0) for n in names}
    rows = []
    for (src, v, g, radius, d_cols, need_src, need_v), _ in calls:
        src, v, g = (None if t is None else t.detach() for t in (src, v, g.contiguous()))
        b, h, w, c = g.shape
        k2 = (2 * radius + 1) ** 2
        flops = 2.0 * b * h * w * c * k2
        row = dict(shape=[b, h, w, c], radius=radius, dtype=str(g.dtype))
        for cast in (lambda t: t, lambda t: None if t is None else t.float()):
            s_, v_, g_ = cast(src), cast(v), cast(g)
            ds, dv = local_combine_backward(s_, v_, g_, radius, d_cols, need_src, need_v)
            rs, rv = local_combine_backward_reference(s_, v_, g_, radius, need_src, need_v)
            tag = str(g_.dtype)
            if need_src:
                check(torch.equal(ds, rs), f"bwd_src {tag} differs at {row}: {max_err(ds, rs)}")
            if need_v:
                check(not dv[..., k2:].any(), f"bwd_v {tag}: columns past K^2 not zero at {row}")
                ok, e = _dv_close(dv[..., :k2], rv, s_, g_, g_.dtype == torch.bfloat16)
                check(ok, f"bwd_v {tag} disagrees at {row}: max abs err {e}")
                tot[names[1]]["err"] = max(tot[names[1]]["err"], e)
        es = g.element_size()
        if need_src:
            t = tot[names[0]]
            ms = device_ms(lambda: local_combine_backward(None, v, g, radius, d_cols, True, False))
            plain = device_ms(lambda: local_combine_backward_reference(None, v, g, radius, True, False),
                              reps=2, behind_sleep=False)
            nbytes = (g.numel() + b * h * w * k2 + b * (h + 2 * radius) * (w + 2 * radius) * c) * es
            bnd, by = bound_ms(nbytes, flops)
            row.update(src_ms=ms, src_plain_ms=plain, src_bound_ms=bnd, src_bound_by=by)
            for k_, val in (("ms", ms), ("plain_ms", plain), ("bytes", nbytes), ("flops", flops),
                            ("calls", 1)):
                t[k_] += val
        if need_v:
            t = tot[names[1]]
            ms = device_ms(lambda: local_combine_backward(src, None, g, radius, d_cols, False, True))
            plain = device_ms(lambda: local_combine_backward_reference(src, None, g, radius, False, True),
                              reps=2, behind_sleep=False)
            nbytes = (src.numel() + g.numel() + b * h * w * d_cols) * es
            bnd, by = bound_ms(nbytes, flops)
            row.update(v_ms=ms, v_plain_ms=plain, v_bound_ms=bnd, v_bound_by=by)
            for k_, val in (("ms", ms), ("plain_ms", plain), ("bytes", nbytes), ("flops", flops),
                            ("calls", 1)):
                t[k_] += val
        rows.append(row)
    out = {}
    for n in names:
        t = tot[n]
        bnd, by = bound_ms(t["bytes"], t["flops"])
        out[n] = dict(max_abs_err=t["err"], ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=bnd,
                      bound_by=by, library_ms=None, calls=t["calls"], detail=rows)
        log(f"  {n}: {t['calls']} calls; kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.2f} ms, "
            f"bound {bnd:.4f} ms ({by}); max abs err {t['err']:.3g}"
            + (" (exact in bf16 and f32)" if n == names[0] else
               " (f32 tol 1e-5 |g||src|, bf16 one ulp)"))
    for r in rows:
        log(f"    {r['shape']} R={r['radius']}: bwd_src {r['src_ms']:.4f} ms (bound "
            f"{r['src_bound_ms']:.4f})"
            + (f", bwd_v {r['v_ms']:.4f} ms (bound {r['v_bound_ms']:.4f})" if "v_ms" in r
               else ", dv not needed"))
    return out


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

    from hoig_torch.ops.local_combine import (local_combine, local_combine_backward_reference,
                                              local_combine_reference)
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
            # the backward kernels through the autograd Function: both sides,
            # then each side alone (needs_input_grad with only one of them)
            g = randn(b, h, w, c).to(dtype)
            rs, rv = local_combine_backward_reference(src, v, g, r)
            k2 = (2 * r + 1) ** 2
            for need_src, need_v in ((True, True), (True, False), (False, True)):
                s_ = src.clone().requires_grad_(need_src)
                v_ = v.clone().requires_grad_(need_v)
                local_combine(s_, v_, r).backward(g)
                what = f"at {tuple(src.shape)} R={r} {dtype} needs=({need_src}, {need_v})"
                check((s_.grad is not None) == need_src and (v_.grad is not None) == need_v,
                      f"LocalCombine gave the wrong gradients {what}")
                if need_src:
                    check(torch.equal(s_.grad, rs), f"bwd_src differs {what}")
                if need_v:
                    ok, e = _dv_close(v_.grad[..., :k2], rv, src, g, dtype == torch.bfloat16)
                    check(ok and not v_.grad[..., k2:].any(), f"bwd_v differs {what}: {e}")
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
    log(f"  ragged shapes: all five kernels agree with their plain versions "
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
                       compute_dtype=torch.float32, remat=False)
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

    # gradient of one fixed scalar of the ten outputs w.r.t. every weight:
    # the card runs the combine's three kernels, the CPU their plain versions.
    # The objects get a random texture for this: on the untextured synthetic
    # objects the generator's object images are constant, and the object
    # branch's norms then amplify rounding noise into its gradients.
    import numpy as np

    tables_np = env_cpu["tables_np"]
    tables_np.obj_tex = (np.random.RandomState(5).rand(*tables_np.obj_tex.shape) * 2 - 1).astype(
        np.float32)
    f_tex = flow_only(batch_as_torch(batch, "cpu"), dict(env_cpu, tables=tables_np.as_torch("cpu")),
                      ccfg)
    kw_tex = generator_kwargs({k: (None if v is None else v[:1].clone()) for k, v in f_tex.items()},
                              torch.as_tensor(batch["maskA"][:1]),
                              torch.as_tensor(batch["maskB"][:1]), True)
    wgen = torch.Generator().manual_seed(7)
    weights = [torch.randn(o.shape, generator=wgen) for o in out_c]

    def grads(model, dev):
        outs = model(**{k: (None if v is None else v.to(dev)) for k, v in kw_tex.items()})
        scalar = sum((o.float() * w.to(dev)).sum() for o, w in zip(outs, weights))
        named = list(model.named_parameters())
        return dict(zip((n for n, _ in named),
                        torch.autograd.grad(scalar, [p for _, p in named])))

    t0 = time.perf_counter()
    gr_c = grads(g_cpu, "cpu")
    cpu_s = time.perf_counter() - t0
    gr_g = grads(g_gpu, "cuda")
    tree_max = max(float(v.abs().max()) for v in gr_c.values())
    rows = []
    for name, ref in gr_c.items():
        got = gr_g[name].cpu()
        check(bool(torch.isfinite(got).all()), f"non-finite gradient of {name} on the card")
        rows.append((float((got - ref).abs().max()), float(ref.abs().max()), name))
    rows.sort(key=lambda r: -max(r[0] / (r[1] + 1e-4 * tree_max), 20 * r[0] / tree_max))
    for e, top, name in rows[:5]:
        log(f"    {name}: max abs err {e:.3g}, leaf max {top:.3g}, largest gradient {tree_max:.3g}")
    # f32 on both sides, TF32 off; ~45 stacked convolutions and norms and their
    # backward passes run other summation orders on the card, and the small
    # leaves' gradients are differences of large terms. 0.1 of a leaf's max is
    # what a missing or mis-signed path would break in any leaf; 5e-3 of the
    # largest gradient bounds the absolute error.
    for e, top, name in rows:
        check(e <= 0.1 * top + 1e-6 * tree_max and e <= 5e-3 * tree_max,
              f"gradient of {name}: card vs CPU max abs err {e} (leaf max {top}, largest {tree_max})")
    worst_leaf = max(e / top for e, top, _ in rows if top > 1e-6 * tree_max)
    worst_tree = max(e / tree_max for e, _, _ in rows)
    log(f"  gradients of a fixed scalar w.r.t. {len(rows)} weight tensors: card vs CPU worst "
        f"{worst_leaf:.3g} of a leaf's max (tol 0.1), {worst_tree:.3g} of the largest gradient "
        f"(tol 5e-3); CPU forward+backward {cpu_s:.1f} s")
    return dict(conditioning_share_off=worst, generator_err=err, grad_err_of_leaf_max=worst_leaf,
                grad_err_of_tree_max=worst_tree)


def _snapshot(tensors: dict) -> dict:
    return {k: v.detach().clone() for k, v in tensors.items()}


def _opt_tensors(opt) -> dict:
    return {(i, k): v for i, st in opt.state_dict()["state"].items() for k, v in st.items()
            if hasattr(v, "shape")}


def training_phase(env, ccfg, batch, serve_fn, out_dir: Path) -> tuple[dict, dict, dict]:
    """The GAN training step at full width on the card, and the profiler
    window over `serve_fn` and one step (see the module docstring, phases 6
    and 7). Returns (kernel results of bwd_src / bwd_v, the training numbers,
    the profile)."""
    import torch

    from hoig_torch.models.vgg import init_vgg
    from hoig_torch.ops import _cuda
    from hoig_torch.train.environment import resolve_corner_engine
    from hoig_torch.train.trainer import TrainConfig, build_networks, init_state, make_train_step

    def config(**remat):
        return TrainConfig(conv_dim=64, repeat_num=6, image_size=IMAGE, use_vgg=True, mask_bce=True,
                           corner_engine=resolve_corner_engine("auto", bf16=True),
                           compute_dtype=torch.bfloat16, **remat)

    def build(tcfg):
        state = init_state(*build_networks(tcfg, device="cuda", seed=0), tcfg)
        vgg = init_vgg(seed=2, compute_dtype=torch.bfloat16, device="cuda")
        return state, make_train_step(vgg, env["tables"], env["mano_params"], ccfg, tcfg)

    def counted_step(state, step, d_trainable):
        _cuda.reset_launch_counts()
        state, m = step(state, batch, d_trainable)
        torch.cuda.synchronize()
        got = _cuda.launch_counts()
        check(got == LAUNCHES_PER_STEP, f"per-step launches {got} != {LAUNCHES_PER_STEP}")
        check(all(bool(torch.isfinite(v)) for v in m.values()), f"non-finite metrics {m}")
        return m

    def timed(state, step, warm, n):
        for _ in range(warm):
            counted_step(state, step, True)
        torch.cuda.reset_peak_memory_stats()
        ms = []
        for _ in range(n):
            t0 = time.perf_counter()
            counted_step(state, step, True)
            ms.append((time.perf_counter() - t0) * 1e3)
        return ms, torch.cuda.max_memory_allocated() / 2**20

    # remat off: the recorded step, the kernel checks, the timed steps, the gated step
    tcfg = config(remat=False)
    state, step = build(tcfg)
    n_g = sum(p.numel() for p in state.g.parameters())
    n_d = sum(p.numel() for p in state.d.parameters())
    before = _snapshot(dict(state.g.named_parameters())), _snapshot(dict(state.d.named_parameters()))
    rec = Recorder()
    with recording(rec):
        torch.cuda.synchronize()
        _cuda.reset_launch_counts()
        state, metrics = step(state, batch, True)
        torch.cuda.synchronize()
        launches = _cuda.launch_counts()
    log(f"  step 1 launches: {launches}; G {n_g / 1e6:.1f} M, D {n_d / 1e6:.1f} M parameters")
    check(launches == LAUNCHES_PER_STEP, f"training step launches {launches} != {LAUNCHES_PER_STEP}")
    check(len(rec.calls["local_combine_backward"]) == LAUNCHES_PER_STEP["local_combine_bwd_src"],
          f"{len(rec.calls['local_combine_backward'])} backward calls recorded")
    check(all(bool(torch.isfinite(v)) for v in metrics.values()), f"non-finite metrics {metrics}")
    log("  step 1 metrics: " + ", ".join(f"{k} {float(v):.4g}" for k, v in metrics.items()))
    # every weight has a finite gradient and moved, unless its gradient is
    # exactly zero (constant object images, a conv bias before a plain norm)
    for net, snap, label in ((state.g, before[0], "G"), (state.d, before[1], "D")):
        still = 0
        for name, p in net.named_parameters():
            check(p.grad is not None and bool(torch.isfinite(p.grad).all()),
                  f"{label} {name}: missing or non-finite gradient")
            if torch.equal(p.detach(), snap[name]):
                check(not bool(p.grad.any()), f"{label} {name} has a gradient but did not move")
                still += 1
        check(still <= 0.05 * len(snap), f"{still} of {len(snap)} {label} weights did not move")
        log(f"  {label}: {len(snap) - still} of {len(snap)} weight tensors moved "
            f"({still} with an all-zero gradient)")
    del before
    results = check_local_combine_backward(rec.calls["local_combine_backward"])
    for name in results:
        results[name]["launches"] = launches[name]
    del rec

    ms, peak = timed(state, step, warm=3, n=6)
    # the gated step leaves D and its Adam state bit-equal
    d_before = _snapshot(dict(state.d.named_parameters()))
    o_before = _snapshot(_opt_tensors(state.opt_d))
    g_before = _snapshot(dict(list(state.g.named_parameters())[:1]))
    m_gated = counted_step(state, step, False)
    check(all(torch.equal(v, d_before[k]) for k, v in state.d.named_parameters()),
          "the gated step moved D's weights")
    o_after = _opt_tensors(state.opt_d)
    check(o_after.keys() == o_before.keys() and all(torch.equal(v, o_before[k]) for k, v in o_after.items()),
          "the gated step moved D's Adam state")
    check(not any(torch.equal(p.detach(), g_before[n]) for n, p in list(state.g.named_parameters())[:1]),
          "the gated step did not train G")
    check(all(k in m_gated for k in ("loss_D", "d_real", "d_fake")), "gated step metrics incomplete")
    med = statistics.median(ms)
    train = dict(step_ms=med, images_per_s=BATCH / (med / 1e3), peak_mem_mb=peak, steps=len(ms),
                 step_ms_all=ms, launches=launches, params_g=n_g, params_d=n_d,
                 metrics={k: float(v) for k, v in metrics.items()})
    log(f"  remat off: step {med:.2f} ms (median of {len(ms)}; {min(ms):.2f}-{max(ms):.2f}), "
        f"{train['images_per_s']:.2f} images/s, peak {peak:.0f} MiB; gated step leaves D bit-equal")

    # 7. one profiler window over both paths
    log("[7] profiler window: 2 serving calls, 1 training step")
    profile = profile_window(serve_fn, lambda: counted_step(state, step, True), out_dir)
    train["device_ms"] = profile.get("hoig_train", {}).get("device_ms")

    # the same step with the bf16 remat defaults (conv blocks recomputed, the
    # bottleneck and the attention kept): memory peak and step time
    del state, step
    torch.cuda.empty_cache()
    state, step = build(config(remat=True, remat_bottleneck=False, remat_attn=False))
    ms, peak = timed(state, step, warm=2, n=4)
    train["remat"] = dict(step_ms=statistics.median(ms), peak_mem_mb=peak, step_ms_all=ms)
    log(f"  remat (conv blocks; bottleneck and attention kept): step "
        f"{train['remat']['step_ms']:.2f} ms (median of {len(ms)}), peak {peak:.0f} MiB")
    return results, train, profile


# device kernel name -> operator class, first match wins
KERNEL_CLASSES = (
    ("hand-written kernels", ("combine_fwd_kernel", "combine_bwd_src_kernel", "combine_bwd_v_kernel",
                              "raster_kernel", "gather_kernel")),
    ("convolutions (cuDNN)", ("xmma", "cudnn", "cutlass", "implicit_gemm", "fprop", "dgrad", "wgrad",
                              "conv")),
    ("matrix products (cuBLAS)", ("gemm", "gemv", "cublas")),
    ("InstanceNorm statistics (var_mean)", ("WelfordOps",)),
    ("Adam and other foreach ops", ("multi_tensor_apply",)),
    ("reductions", ("reduce_kernel",)),
    ("concatenations", ("CatArray",)),
    ("gathers, scatters, index ops", ("gather", "scatter", "index")),
    ("casts and copies", ("copy", "Memcpy", "Memset")),
    ("pooling and softmax", ("max_pool", "softmax")),
    ("elementwise", ("elementwise",)),
)


def kernel_class(name: str) -> str:
    return next((label for label, keys in KERNEL_CLASSES if any(k in name for k in keys)), "other")


def profile_window(serve_fn, train_fn, out_dir: Path) -> dict:
    """Device time by kernel over two serving calls and one training step, in
    ONE torch.profiler session (a second session in the same process lost its
    device events on this machine): the two regions are told apart by the
    time ranges of their annotations, each closed after a synchronize."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    regions = {"hoig_serve": 2, "hoig_train": 1}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("hoig_serve"):
            for _ in range(2):
                serve_fn()
            torch.cuda.synchronize()
        with record_function("hoig_train"):
            train_fn()
            torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    events = list(prof.events())
    spans = {e.name: (e.time_range.start, e.time_range.end) for e in events
             if e.name in regions and e.device_type != cuda}
    # annotations (these regions, Optimizer.step) are mirrored on the device
    # timeline under the host-side names: they are spans, not kernels
    host_names = {e.name for e in events if e.device_type != cuda}
    device = [e for e in events if e.device_type == cuda and e.name not in host_names]
    (out_dir / "profile.txt").write_text(
        prof.key_averages().table(sort_by="device_time_total", row_limit=80))
    out = {}
    for region, n in regions.items():
        if region not in spans:
            log(f"  profiler: no span for {region} (not measured)")
            continue
        lo, hi = spans[region]
        by_name: dict = {}
        for e in device:
            if lo <= e.time_range.start <= hi:
                acc = by_name.setdefault(e.name, [0.0, 0])
                acc[0] += e.time_range.elapsed_us()
                acc[1] += 1
        if not by_name:
            log(f"  profiler: no device time reported for {region} (not measured)")
            continue
        total = sum(v[0] for v in by_name.values())
        table = sorted(({"name": k[:90], "ms": v[0] / n / 1e3, "count": v[1] // n}
                        for k, v in by_name.items()), key=lambda r: -r["ms"])
        wall = (hi - lo) / n / 1e3
        log(f"  profiler {region}: device busy {total / n / 1e3:.2f} ms of {wall:.2f} ms wall per "
            f"{'call' if region == 'hoig_serve' else 'step'} ({total / n / 1e3 / wall:.0%}), "
            f"{sum(v[1] for v in by_name.values()) // n} device kernels; top kernels:")
        for row in table[:10]:
            log(f"    {row['ms']:8.3f} ms  x{row['count']:<5d} {row['name']}")
        classes: dict = {}
        for k, v in by_name.items():
            classes[kernel_class(k)] = classes.get(kernel_class(k), 0.0) + v[0] / n / 1e3
        log("    by operator class: " + "; ".join(
            f"{label} {ms:.2f} ms ({ms / (total / n / 1e3):.0%})"
            for label, ms in sorted(classes.items(), key=lambda kv: -kv[1])))
        out[region] = dict(device_ms=total / n / 1e3, wall_ms=wall, classes=classes,
                           kernels=table[:60])
    return out


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

    # 6. the training step
    log(f"[6] training step: {IMAGE} px, batch {BATCH}, bf16, shift engine, conv_dim 64, repeat 6, "
        "PatchGAN-4, VGG19 loss, mask BCE")
    bwd_results, train, profile = training_phase(
        env, ccfg, batch,
        lambda: forward_only(gen, flow_only(batch, env, ccfg), batch, tcfg), out_dir)
    results.update(bwd_results)

    # 8. report
    kernels = []
    for name, (src, replaces) in KERNELS.items():
        r = results[name]
        kernels.append(dict(name=name, route="cuda", source=src, replaces=replaces,
                            launches=train["launches"][name], launches_serving=launches.get(name, 0),
                            max_abs_err=r["max_abs_err"], ms=r["ms"],
                            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                            library_ms=r["library_ms"]))
    detail = dict(card=card, torch=torch.__version__, cuda=torch.version.cuda, build_s=build_s,
                  kernels=results, cpu_compare=cpu_cmp, serving=serve, training=train,
                  profile=profile)
    (out_dir / "result.json").write_text(json.dumps(detail, indent=1, default=str))
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
