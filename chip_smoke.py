#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path and its GAN training step on one
NVIDIA GPU, with the shift attention engine and with the fused one.

    python3 chip_smoke.py [--out DIR]   # from the root of a checkout, one card

Phases (any failure exits non-zero, nothing falls back to the CPU):
  1. the card's name and power limit, torch and CUDA versions;
  2. build the hand-written kernels from hoig_torch/csrc (one nvcc each, in
     parallel), report the build seconds, and hold the tile constants that
     hoig_torch/ops/attn_fused.py and local_combine.py repeat (TILING)
     against the libraries';
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
  6. the fused attention engine (corner_engine "pallas", the four B4
     kernels of hoig_torch/csrc/attn_fused.cu; under bf16, B4-fwd's phase A,
     B4-bwd-a-gsrc's projection and B4-bwd-a-dw run on the tensor cores,
     counted as attn_fused_fwd_tc, attn_fused_bwd_a_gsrc_tc and
     attn_fused_bwd_a_dw_tc; B4-bwd-c is bwd_c_kernel, V and the padded
     gradient kept on chip, with bwd_c_gattn_kernel for g_attn's last sum)
     on the same model, data and weights: (a) one
     serving call from launch counters at 0 (9 / 1 / 2 launches of B4-fwd /
     rasterizer / gather, no combine) with B4-fwd held against its plain
     version on the nine recorded inputs; (b) one training step (remat off)
     from counters at 0 (9 of each B4 kernel, 1 / 2 of B2 / B3), each
     backward kernel held against its plain version on the recorded inputs
     (dW on the dG that B4-bwd-a-gsrc returned), finite metrics, every G
     weight moved; each B4 kernel called twice on each input and held
     bit-equal to itself (B4-bwd-c's source gradient also bit-equal to the
     plain version, bf16 and f32), and timed beside its plain version, its
     library yardstick (cuDNN conv2d, conv_transpose2d and the weight gradient of
     the three tensor-core products alone, named in the kernels line's
     "library" key) and its FP32 path on the f32-cast inputs; the same first
     step twice more with remat off (their G gradients measure the card's
     run-to-run noise) and once with remat and remat_attn on (18 B4-fwd
     launches: the recompute runs each layer's forward again), its G
     gradients held against the remat-off step's; (c) all four kernels on
     ragged shapes, and B4-bwd-c also on frames with H or W equal to 1 and
     below 11 (one pixel collects both margins); (d) fused and shift engines
     agree on the card
     in f32 (TF32 off), 128 px, batch 1, outputs and the gradients of a fixed
     scalar; (e) the fused serving call and step timed as in phases 5 and 7,
     each B4 kernel and its plain version timed, and the shift engine's
     ExtractorAttn on the same layer inputs as a yardstick (the training
     state is freed before phase 7, and rebuilt for phase 8);
  7. the training step (make_train_step: conditioning, generator, G losses
     with VGG and the PatchGAN-4 discriminator, both Adam updates) at full
     width, 256 px, batch 4, bf16, shift engine: one step from launch
     counters at 0 with the backward kernels' inputs recorded, then bwd_src
     and bwd_v held against their plain versions on those inputs: bf16 as
     recorded through the tensor-core kernels (counted as
     local_combine_bwd_src_tc and local_combine_bwd_v_tc; each called twice
     and held bit-equal to itself; dsrc within one bf16 ulp plus 1e-5 of the
     largest sum of |v||g|, with the count of elements that differ; dv
     within one ulp plus 1e-5 of |g||src|), and cast to f32 through the FP32
     kernels (dsrc bit-equal); then timed beside their plain versions and
     the FP32 kernels; warm and timed steps with the per-step launch counts
     (18 / 18 / 9 / 1 / 2) asserted, finite metrics, every weight moved, D
     bit-equal across a gated step; the same again with the bf16 remat
     defaults for the memory peak;
  8. one profiler window over two serving calls and one training step with
     each engine splits the device time of each by kernel, and asserts 9
     launches of dg_kernel, dw_tc_kernel, bwd_c_kernel, bwd_c_gattn_kernel
     and fold_kernel per fused step, and 18 of combine_fwd_kernel and of
     combine_bwd_src_tc_kernel, 9 of combine_bwd_v_tc_kernel and none of
     the FP32 backward kernels per shift step;
  9. print the kernels line, the card line and, last, the result line.

Details (result.json, profile.txt, build.txt: the compiler's report) go to
--out, by default build/chip_smoke/.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, FP32 non-tensor
# FLOP/s, bf16 dense tensor-core FLOP/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_TC_FLOPS = 989e12
# source of each kernel and the TPU kernel it replaces
KERNELS = {
    "local_combine": ("hoig_torch/csrc/local_combine.cu", "hoig_tpu/ops/local_combine.py:50"),
    "local_combine_bwd_src_tc": ("hoig_torch/csrc/local_combine.cu",
                                 "hoig_tpu/ops/local_combine.py:62"),
    "local_combine_bwd_v_tc": ("hoig_torch/csrc/local_combine.cu",
                               "hoig_tpu/ops/local_combine.py:80"),
    "rasterizer": ("hoig_torch/csrc/rasterizer.cu", "hoig_tpu/ops/rasterizer_pallas.py:45"),
    "table_gather": ("hoig_torch/csrc/table_gather.cu", "hoig_tpu/ops/table_gather.py:77"),
    "attn_fused_fwd_tc": ("hoig_torch/csrc/attn_fused.cu", "hoig_tpu/ops/attn_pallas.py:211"),
    "attn_fused_bwd_c": ("hoig_torch/csrc/attn_fused.cu", "hoig_tpu/ops/attn_pallas.py:628"),
    "attn_fused_bwd_a_gsrc_tc": ("hoig_torch/csrc/attn_fused.cu",
                                 "hoig_tpu/ops/attn_pallas.py:321"),
    "attn_fused_bwd_a_dw_tc": ("hoig_torch/csrc/attn_fused.cu",
                               "hoig_tpu/ops/attn_pallas.py:409"),
}
# the four B4 wrappers, and the counter each one's bf16 launch adds to: under
# bf16, B4-fwd's phase A, the gsrc projection and dW run on the tensor cores
FUSED = ("attn_fused_fwd", "attn_fused_bwd_c", "attn_fused_bwd_a_gsrc", "attn_fused_bwd_a_dw")
FUSED_BF16 = {"attn_fused_fwd": "attn_fused_fwd_tc", "attn_fused_bwd_c": "attn_fused_bwd_c",
              "attn_fused_bwd_a_gsrc": "attn_fused_bwd_a_gsrc_tc",
              "attn_fused_bwd_a_dw": "attn_fused_bwd_a_dw_tc"}
# launches per serving call, and per training step: each of the 9 attention
# layers combines twice forward; both calls need dsrc, only the second (whose
# coefficients come from the attention, not from the no-grad flow) needs dv.
# Under bf16 both backward kernels run on the tensor cores (counters *_tc).
LAUNCHES_PER_CALL = {"local_combine": 18, "rasterizer": 1, "table_gather": 2}
LAUNCHES_PER_STEP = {"local_combine": 18, "local_combine_bwd_src_tc": 18,
                     "local_combine_bwd_v_tc": 9, "rasterizer": 1, "table_gather": 2}
# the fused engine: one forward and one backward of each of the 9 layers
FUSED_LAUNCHES_PER_CALL = {"attn_fused_fwd_tc": 9, "rasterizer": 1, "table_gather": 2}
FUSED_LAUNCHES_PER_STEP = {**{k: 9 for k in FUSED_BF16.values()}, "rasterizer": 1,
                           "table_gather": 2}
# under remat_attn the backward recomputes each layer's forward
FUSED_LAUNCHES_PER_STEP_REMAT = dict(FUSED_LAUNCHES_PER_STEP, attn_fused_fwd_tc=18)
IMAGE, BATCH = 256, 4
# B4 kernel vs plain version on the card. f32 inputs: within 1e-5 of the
# output's largest magnitude (only the order of the f32 sums differs).
# bf16 inputs: `out` and bwd-c's source gradient within one bf16 ulp (2^-7)
# of the largest magnitude (a last-bit difference of an f32 sum can move a
# bf16-rounded product or output by one ulp); the f32 residuals acc, attn
# and g_attn within 1e-4 of it (channel sums in another order); the gsrc
# projection, dG and dW within 1e-5, as in f32: the tensor-core forms of
# the projection and of dW take JAX's exact f32 products (dG split in three
# bf16 parts), so a dG rounded to bf16 (about 4e-3) fails.
TOL_F32 = 1e-5
TOL_BF16 = 2.0 ** -7
TOL_RESID = 1e-4


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
        self.calls = {name: [] for name in (*KERNELS, *FUSED, "local_combine_backward")}

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
    import hoig_torch.ops.attn_fused as af
    import hoig_torch.ops.local_combine as lc
    import hoig_torch.ops.rasterizer_cuda as rc

    sites = [(af, name, name) for name in FUSED] + [
             (gen, "local_combine", "local_combine"),
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


def bound_ms(nbytes: float, flops: float, tc_flops: float = 0.0) -> tuple[float, str]:
    """The larger of bytes over the memory rate and operations over their
    peak: FP32 on the CUDA cores, and bf16 products (`tc_flops`) on the
    tensor cores."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = (flops / PEAK_FP32_FLOPS + tc_flops / PEAK_BF16_TC_FLOPS) * 1e3
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
    """bwd_v sums each channel dot in its own order (FP32: ascending channels,
    fused multiply-adds; tensor cores: their order within each split of the
    channels, the splits added in order), the plain version in torch.sum's.
    f32: |err| <= 1e-5 of the largest |g[p]| * |src[q]| (the bound of any
    such dot). bf16: both round an f32 dot to bf16, so they differ by at
    most one bf16 ulp (2^-7 of the value) where the f32 sums straddle a
    rounding boundary."""
    scale = float(g.float().norm(dim=-1).max() * src.float().norm(dim=-1).max())
    err = (dv.float() - ref.float()).abs()
    tol = 1e-5 * scale + (2.0 ** -7 * ref.float().abs() if dtype_is_bf16 else 0.0)
    return bool((err <= tol).all()), float(err.max())


def _dsrc_close(ds, ref, v, g, radius: int) -> tuple[bool, float, int]:
    """bf16 bwd_src on the tensor cores forms the plain version's exact
    bf16 x bf16 products but adds them in the tensor cores' order, in f32,
    and rounds once to bf16: within one bf16 ulp (2^-7 of the value) of the
    plain value, plus 1e-5 of the largest sum of |v| |g| over the offsets
    (the f32 sums' own difference, where the value is small). Returns (ok,
    max abs err, number of elements that differ)."""
    from hoig_torch.ops.local_combine import local_combine_backward_reference

    mags, _ = local_combine_backward_reference(None, v.float().abs(), g.float().abs(), radius,
                                               True, False)
    err = (ds.float() - ref.float()).abs()
    tol = 1e-5 * float(mags.max()) + 2.0 ** -7 * ref.float().abs()
    return bool((err <= tol).all()), float(err.max()), int((ds != ref).sum())


def check_local_combine_backward(calls) -> dict:
    """B1-bwd-src and B1-bwd-v on every recorded backward call: bf16 as
    recorded, through the tensor-core kernels, each called twice and held
    bit-equal to itself, dsrc within _dsrc_close and dv within _dv_close of
    the plain versions (with the count of dsrc elements that differ); the
    same inputs in f32 through the FP32 kernels, dsrc bit-equal (they repeat
    the plain loop's order and rounding), dv within _dv_close. Timed: the
    bf16 kernels (bound by bytes, or by their products at the tensor cores'
    rate), their plain versions, and the FP32 kernels on the f32 inputs."""
    import torch

    from hoig_torch.ops.local_combine import (local_combine_backward,
                                              local_combine_backward_reference)

    names = ("local_combine_bwd_src_tc", "local_combine_bwd_v_tc")
    tot = {n: dict(ms=0.0, plain_ms=0.0, f32_ms=0.0, bytes=0.0, flops=0.0, err=0.0, calls=0,
                   differ=0, elements=0) for n in names}
    rows = []
    for (src, v, g, radius, d_cols, need_src, need_v), _ in calls:
        src, v, g = (None if t is None else t.detach() for t in (src, v, g.contiguous()))
        check(g.dtype == torch.bfloat16, f"the training step's backward is {g.dtype}, not bf16")
        b, h, w, c = g.shape
        k2 = (2 * radius + 1) ** 2
        flops = 2.0 * b * h * w * c * k2
        row = dict(shape=[b, h, w, c], radius=radius, dtype=str(g.dtype))
        for cast in (lambda t: t, lambda t: None if t is None else t.float()):
            s_, v_, g_ = cast(src), cast(v), cast(g)
            lowp = g_.dtype == torch.bfloat16
            ds, dv = local_combine_backward(s_, v_, g_, radius, d_cols, need_src, need_v)
            rs, rv = local_combine_backward_reference(s_, v_, g_, radius, need_src, need_v)
            tag = str(g_.dtype)
            if lowp:
                ds2, dv2 = local_combine_backward(s_, v_, g_, radius, d_cols, need_src, need_v)
                check(all(x is None or torch.equal(x, y) for x, y in ((ds, ds2), (dv, dv2))),
                      f"the tensor-core backward gave other bits on a second call at {row}")
            if need_src:
                if lowp:
                    ok, e, n_diff = _dsrc_close(ds, rs, v_, g_, radius)
                    check(ok, f"bwd_src_tc disagrees at {row}: max abs err {e}")
                    t = tot[names[0]]
                    t["err"] = max(t["err"], e)
                    t["differ"] += n_diff
                    t["elements"] += ds.numel()
                    row.update(src_err=e, src_differ=n_diff)
                else:
                    check(torch.equal(ds, rs), f"bwd_src {tag} differs at {row}: {max_err(ds, rs)}")
            if need_v:
                check(not dv[..., k2:].any(), f"bwd_v {tag}: columns past K^2 not zero at {row}")
                ok, e = _dv_close(dv[..., :k2], rv, s_, g_, lowp)
                check(ok, f"bwd_v {tag} disagrees at {row}: max abs err {e}")
                tot[names[1]]["err"] = max(tot[names[1]]["err"], e)
        es = g.element_size()
        g32 = g.float()
        if need_src:
            t = tot[names[0]]
            v32 = v.float()
            ms = device_ms(lambda: local_combine_backward(None, v, g, radius, d_cols, True, False))
            f32_ms = device_ms(lambda: local_combine_backward(None, v32, g32, radius, d_cols, True,
                                                              False))
            plain = device_ms(lambda: local_combine_backward_reference(None, v, g, radius, True, False),
                              reps=2, behind_sleep=False)
            nbytes = (g.numel() + b * h * w * k2 + b * (h + 2 * radius) * (w + 2 * radius) * c) * es
            bnd, by = bound_ms(nbytes, 0.0, flops)
            row.update(src_ms=ms, src_plain_ms=plain, src_f32_ms=f32_ms, src_bound_ms=bnd,
                       src_bound_by=by)
            for k_, val in (("ms", ms), ("plain_ms", plain), ("f32_ms", f32_ms), ("bytes", nbytes),
                            ("flops", flops), ("calls", 1)):
                t[k_] += val
            del v32
        if need_v:
            t = tot[names[1]]
            s32 = src.float()
            ms = device_ms(lambda: local_combine_backward(src, None, g, radius, d_cols, False, True))
            f32_ms = device_ms(lambda: local_combine_backward(s32, None, g32, radius, d_cols, False,
                                                              True))
            plain = device_ms(lambda: local_combine_backward_reference(src, None, g, radius, False, True),
                              reps=2, behind_sleep=False)
            nbytes = (src.numel() + g.numel() + b * h * w * d_cols) * es
            bnd, by = bound_ms(nbytes, 0.0, flops)
            row.update(v_ms=ms, v_plain_ms=plain, v_f32_ms=f32_ms, v_bound_ms=bnd, v_bound_by=by)
            for k_, val in (("ms", ms), ("plain_ms", plain), ("f32_ms", f32_ms), ("bytes", nbytes),
                            ("flops", flops), ("calls", 1)):
                t[k_] += val
            del s32
        rows.append(row)
    out = {}
    for n in names:
        t = tot[n]
        bnd, by = bound_ms(t["bytes"], 0.0, t["flops"])
        f32_bnd, _ = bound_ms(t["bytes"] * 2, t["flops"])
        out[n] = dict(max_abs_err=t["err"], ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=bnd,
                      bound_by=by, library_ms=None, f32_ms=t["f32_ms"], f32_bound_ms=f32_bnd,
                      calls=t["calls"], detail=rows)
        if n == names[0]:
            out[n].update(differ=t["differ"], elements=t["elements"])
        log(f"  {n}: {t['calls']} calls; kernel {t['ms']:.4f} ms, FP32 path {t['f32_ms']:.4f} ms, "
            f"plain {t['plain_ms']:.2f} ms, bound {bnd:.4f} ms ({by}); max abs err {t['err']:.3g}"
            + (f" (bf16 one ulp + 1e-5 of the largest sum of |v||g|; {t['differ']} of "
               f"{t['elements']} elements differ; f32 exact)" if n == names[0] else
               " (f32 tol 1e-5 |g||src|, bf16 one ulp)"))
    for r in rows:
        log(f"    {r['shape']} R={r['radius']}: bwd_src {r['src_ms']:.4f} ms (bound "
            f"{r['src_bound_ms']:.4f}, FP32 {r['src_f32_ms']:.4f})"
            + (f", bwd_v {r['v_ms']:.4f} ms (bound {r['v_bound_ms']:.4f}, FP32 {r['v_f32_ms']:.4f})"
               if "v_ms" in r else ", dv not needed"))
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
                bound_by=by, library_ms=tot["library_ms"], library="torch.take_along_dim")


def check_ragged_shapes() -> None:
    """Each kernel against its plain version on small shapes its wrapper
    takes but the main path does not give it: partial pixel tiles and
    channel chunks, extra coefficient columns, an image size off the tile
    grid, a partial face chunk, a narrow table."""
    import torch

    from hoig_torch.ops.local_combine import (local_combine, local_combine_backward,
                                              local_combine_backward_reference,
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
            if dtype == torch.bfloat16:  # the tensor-core kernels add in a fixed order
                once, again = (local_combine_backward(src, v, g, r, v.shape[3]) for _ in range(2))
                check(all(torch.equal(x, y) for x, y in zip(once, again)),
                      f"the tensor-core backward gave other bits on a second call at "
                      f"{tuple(src.shape)} R={r}")
            for need_src, need_v in ((True, True), (True, False), (False, True)):
                s_ = src.clone().requires_grad_(need_src)
                v_ = v.clone().requires_grad_(need_v)
                local_combine(s_, v_, r).backward(g)
                what = f"at {tuple(src.shape)} R={r} {dtype} needs=({need_src}, {need_v})"
                check((s_.grad is not None) == need_src and (v_.grad is not None) == need_v,
                      f"LocalCombine gave the wrong gradients {what}")
                if need_src and dtype == torch.float32:
                    check(torch.equal(s_.grad, rs), f"bwd_src differs {what}")
                elif need_src:
                    ok, e, _ = _dsrc_close(s_.grad, rs, v, g, r)
                    check(ok, f"bwd_src_tc differs {what}: max abs err {e}")
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


def train_config(engine: str, **remat):
    """The full-width bf16 training configuration of phases 6 and 7."""
    import torch

    from hoig_torch.train.trainer import TrainConfig

    return TrainConfig(conv_dim=64, repeat_num=6, image_size=IMAGE, use_vgg=True, mask_bce=True,
                       corner_engine=engine, compute_dtype=torch.bfloat16, **remat)


def build_step(env, ccfg, tcfg):
    """A fresh training state (weights from seed 0) and its step function."""
    import torch

    from hoig_torch.models.vgg import init_vgg
    from hoig_torch.train.trainer import build_networks, init_state, make_train_step

    state = init_state(*build_networks(tcfg, device="cuda", seed=0), tcfg)
    vgg = init_vgg(seed=2, compute_dtype=torch.bfloat16, device="cuda")
    return state, make_train_step(vgg, env["tables"], env["mano_params"], ccfg, tcfg)


def counted_step(state, step, batch, d_trainable, expected: dict):
    """One step from launch counters at 0; asserts the launches and finite metrics."""
    import torch

    from hoig_torch.ops import _cuda

    _cuda.reset_launch_counts()
    state, m = step(state, batch, d_trainable)
    torch.cuda.synchronize()
    got = _cuda.launch_counts()
    check(got == expected, f"per-step launches {got} != {expected}")
    check(all(bool(torch.isfinite(v)) for v in m.values()), f"non-finite metrics {m}")
    return m


def timed_steps(state, step, batch, expected: dict, warm: int, n: int):
    """Host ms of n steps after `warm` ones, and the peak device MiB."""
    import torch

    for _ in range(warm):
        counted_step(state, step, batch, True, expected)
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for _ in range(n):
        t0 = time.perf_counter()
        counted_step(state, step, batch, True, expected)
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms, torch.cuda.max_memory_allocated() / 2**20


def recorded_step(state, step, batch, expected: dict, rec) -> tuple[dict, dict]:
    """The first step from launch counters at 0, with the kernels' inputs
    recorded; asserts the launches, finite metrics, and that every weight got
    a finite gradient and moved unless its gradient is exactly zero (constant
    object images, a conv bias before a plain norm). Returns (metrics, launches)."""
    import torch

    from hoig_torch.ops import _cuda

    n_g = sum(p.numel() for p in state.g.parameters())
    n_d = sum(p.numel() for p in state.d.parameters())
    before = _snapshot(dict(state.g.named_parameters())), _snapshot(dict(state.d.named_parameters()))
    with recording(rec):
        torch.cuda.synchronize()
        _cuda.reset_launch_counts()
        state, metrics = step(state, batch, True)
        torch.cuda.synchronize()
        launches = _cuda.launch_counts()
    log(f"  step 1 launches: {launches}; G {n_g / 1e6:.1f} M, D {n_d / 1e6:.1f} M parameters")
    check(launches == expected, f"training step launches {launches} != {expected}")
    check(all(bool(torch.isfinite(v)) for v in metrics.values()), f"non-finite metrics {metrics}")
    log("  step 1 metrics: " + ", ".join(f"{k} {float(v):.4g}" for k, v in metrics.items()))
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
    return {k: float(v) for k, v in metrics.items()}, launches


def training_phase(env, ccfg, batch, regions: dict, more_regions, out_dir: Path
                   ) -> tuple[dict, dict, dict]:
    """The GAN training step at full width on the card with the shift engine,
    and the profiler window over `regions`, the regions `more_regions()`
    builds, and one such step (see the module docstring, phases 7 and 8).
    Returns (kernel results of bwd_src / bwd_v, the training numbers, the
    profile)."""
    import torch

    from hoig_torch.train.environment import resolve_corner_engine

    def config(**remat):
        return train_config(resolve_corner_engine("auto", bf16=True), **remat)

    # remat off: the recorded step, the kernel checks, the timed steps, the gated step
    state, step = build_step(env, ccfg, config(remat=False))
    n_g = sum(p.numel() for p in state.g.parameters())
    n_d = sum(p.numel() for p in state.d.parameters())
    rec = Recorder()
    metrics, launches = recorded_step(state, step, batch, LAUNCHES_PER_STEP, rec)
    check(len(rec.calls["local_combine_backward"]) == LAUNCHES_PER_STEP["local_combine_bwd_src_tc"],
          f"{len(rec.calls['local_combine_backward'])} backward calls recorded")
    results = check_local_combine_backward(rec.calls["local_combine_backward"])
    for name in results:
        results[name]["launches"] = launches[name]
    del rec

    ms, peak = timed_steps(state, step, batch, LAUNCHES_PER_STEP, warm=3, n=6)
    # the gated step leaves D and its Adam state bit-equal
    d_before = _snapshot(dict(state.d.named_parameters()))
    o_before = _snapshot(_opt_tensors(state.opt_d))
    g_before = _snapshot(dict(list(state.g.named_parameters())[:1]))
    m_gated = counted_step(state, step, batch, False, LAUNCHES_PER_STEP)
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
                 step_ms_all=ms, launches=launches, params_g=n_g, params_d=n_d, metrics=metrics)
    log(f"  remat off: step {med:.2f} ms (median of {len(ms)}; {min(ms):.2f}-{max(ms):.2f}), "
        f"{train['images_per_s']:.2f} images/s, peak {peak:.0f} MiB; gated step leaves D bit-equal")

    # 8. one profiler window over both paths of both engines
    log("[8] profiler window: 2 serving calls and 1 training step, each engine")
    regions = dict(regions, **more_regions(), hoig_train=(
        lambda: counted_step(state, step, batch, True, LAUNCHES_PER_STEP), 1))
    profile = profile_window(regions, out_dir)
    del regions
    train["device_ms"] = profile.get("hoig_train", {}).get("device_ms")

    # the same step with the bf16 remat defaults (conv blocks recomputed, the
    # bottleneck and the attention kept): memory peak and step time
    del state, step
    torch.cuda.empty_cache()
    state, step = build_step(env, ccfg, config(remat=True, remat_bottleneck=False, remat_attn=False))
    ms, peak = timed_steps(state, step, batch, LAUNCHES_PER_STEP, warm=2, n=4)
    train["remat"] = dict(step_ms=statistics.median(ms), peak_mem_mb=peak, step_ms_all=ms)
    log(f"  remat (conv blocks; bottleneck and attention kept): step "
        f"{train['remat']['step_ms']:.2f} ms (median of {len(ms)}), peak {peak:.0f} MiB")
    return results, train, profile


def _fused_cost(name: str, args) -> tuple[float, float, float]:
    """(bytes, FP32 operations, bf16 tensor-core operations) of one B4 launch
    on these inputs: each input read once, each output written once (dG is
    an output of bwd-a-gsrc and an input of dW); the coefficient terms only
    where nonzero (4 of 49 for acc and dG, 36 of 121 per pixel for phase C
    and bwd-c). Each 5x5 product is counted over the (H+6) x (W+6) frame of
    G or dG: the forward needs G only there, and dG is zero outside it, so
    the gsrc projection and dW pair each of its pixels with the 25 offsets
    once. Under bf16 the three products run on the tensor cores, the gsrc
    one and dW as three bf16 passes (dG split into hi + mid + lo): JAX's f32
    product."""
    F, K2 = 128, 25
    if name == "attn_fused_bwd_a_gsrc":
        g_acc, w0s = args[0], args[5]
        b, h, w, _ = g_acc.shape
        c, es = w0s.shape[1], w0s.element_size()
    else:
        b, h, w, c = args[0].shape
        es = args[0].element_size()
    lowp = es == 2
    n = b * h * w
    n_halo = b * (h + 6) * (w + 6)
    fields = 4 * n * 4
    conv_halo = 2.0 * n_halo * K2 * c * F
    if name == "attn_fused_fwd":
        nbytes = (2 * n * c + K2 * c * F) * es + (2 * n * F + n * K2 + F * K2 + K2) * 4 + fields
        f32_ops = 2.0 * n * (4 * F + F * K2 + 36 * c)
        return nbytes, f32_ops + (0.0 if lowp else conv_halo), conv_halo if lowp else 0.0
    if name == "attn_fused_bwd_c":
        nbytes = 2 * n * c * es + (n * c + 2 * n * K2) * 4 + fields
        return nbytes, 2.0 * n * 36 * c * 2, 0.0
    if name == "attn_fused_bwd_a_gsrc":
        nbytes = K2 * c * F * es + (n * F + n * c + n_halo * F) * 4 + fields
        dg_ops = 2.0 * n * 4 * F
        return (nbytes, dg_ops, 3 * conv_halo) if lowp else (nbytes, dg_ops + conv_halo, 0.0)
    nbytes = n * c * es + (n_halo * F + K2 * c * F) * 4
    return (nbytes, 0.0, 3 * conv_halo) if lowp else (nbytes, conv_halo, 0.0)


def _fused_shape(name: str, args) -> list:
    """(B, H, W, C) of a B4 call (bwd-a-gsrc takes g_acc, 128 wide, and w0s)."""
    if name == "attn_fused_bwd_a_gsrc":
        return list(args[0].shape[:3]) + [args[5].shape[1]]
    return list(args[0].shape)


def _tuple(x) -> tuple:
    return x if isinstance(x, tuple) else (x,)


def _within(got, ref, rel: float) -> tuple[bool, float]:
    err = max_err(got, ref)
    return err <= rel * float(ref.float().abs().max()), err


def _library_call(name: str, args):
    """The one PyTorch call that computes a B4 kernel's 5x5 product on the
    same inputs, as a yardstick the port never calls, or None: cuDNN's
    conv2d of the bf16 edge-padded source with the (128, C, 5, 5) weight for
    B4-fwd's phase A, its conv_transpose2d of the f32 dG with the
    f32-widened weight for the gsrc projection, and its weight gradient
    (convolution_backward, weight output only) of that conv2d from the f32
    dG and the f32-widened edge-padded source for dW. The call's inputs are
    made outside the timed call."""
    import torch
    import torch.nn.functional as F_

    from hoig_torch.ops import attn_fused as af

    if name == "attn_fused_fwd":
        src, w0s = args[0], args[2]
        x = af._nchw(af.edge_pad(src, af.PAD))
        wt = af._conv_weight(w0s).to(src.dtype).contiguous(memory_format=torch.channels_last)
        return lambda: F_.conv2d(x, wt)
    if name == "attn_fused_bwd_a_gsrc":
        x = af._nchw(af._dg_reference(args[0], *af.coeff_axes(*args[1:5])))
        wt = af._conv_weight(args[5]).contiguous(memory_format=torch.channels_last)
        return lambda: F_.conv_transpose2d(x, wt)
    if name == "attn_fused_bwd_a_dw":
        src, dg = args
        x = af._nchw(af.edge_pad(src, af.PAD).float())
        g = af._nchw(dg)
        wt = torch.empty((af.F, src.shape[3], af.K, af.K), device=src.device).contiguous(
            memory_format=torch.channels_last)  # only its shape is read
        return lambda: torch.ops.aten.convolution_backward(
            g, x, wt, None, [1, 1], [0, 0], [1, 1], False, [0, 0], 1, [False, True, False])[1]
    return None


def _library_dw(grad_weight):
    """cuDNN's (128, C, 5, 5) weight gradient in dW's (25, C, 128) layout."""
    return grad_weight.permute(2, 3, 1, 0).reshape(25, grad_weight.shape[1], grad_weight.shape[0])


# outputs held bit-equal to the plain version, bf16 and f32: B4-bwd-c's
# source gradient sums its rounded products and folds the margins in the
# plain version's order
EXACT = {"attn_fused_bwd_c": (0,)}


def check_fused_kernel(name: str, calls) -> dict:
    """The B4 kernel of wrapper `name` on every recorded call of the main
    path: against its plain version with the inputs as recorded (bf16) and
    cast to f32, with the tolerances of TOL_* (bit-equal for the outputs in
    EXACT); the bf16 call made twice and
    held bit-equal (the kernels add in a fixed order: a missing fence or
    barrier shows as a difference); then timed, summed over the launches
    (the kernel behind a GPU sleep): the kernel, its plain version, the
    library yardstick where there is one and, for the two tensor-core
    kernels, their FP32 path on the same inputs cast to f32. Fails if the
    kernel reads faster than its bound (the count would be wrong)."""
    import torch

    from hoig_torch.ops import attn_fused as af

    kern, plain = getattr(af, name), getattr(af, name + "_reference")
    # the three kernels with a tensor-core entry point under bf16, and the
    # one PyTorch call of their 5x5 product alone (library_ms)
    library = {"attn_fused_fwd": "cuDNN conv2d of phase A's 5x5 product alone",
               "attn_fused_bwd_a_gsrc": "cuDNN conv_transpose2d of the gsrc projection alone",
               "attn_fused_bwd_a_dw": "cuDNN weight gradient (aten.convolution_backward, weight "
                                      "only) of the 5x5 product, f32"}.get(name)
    # per output, under bf16 inputs: out / gsrc_c one ulp; residuals 1e-4;
    # the gsrc projection, dG and dW (exact f32 products) 1e-5
    tols = {"attn_fused_fwd": (TOL_BF16, TOL_RESID, TOL_RESID),
            "attn_fused_bwd_c": (TOL_BF16, TOL_RESID),
            "attn_fused_bwd_a_gsrc": (TOL_F32, TOL_F32), "attn_fused_bwd_a_dw": (TOL_F32,)}[name]
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0.0, f32=0.0, tc=0.0, f32_ms=0.0,
               f32_bytes=0.0, f32_f32=0.0)
    err16 = [0.0] * len(tols)
    err32 = [0.0] * len(tols)
    rel16 = [0.0] * len(tols)  # max abs err over the output's largest magnitude
    rel32 = [0.0] * len(tols)
    exact = [True] * len(tols)
    rows = []
    for args, _ in calls:
        args = tuple(a.detach() for a in args)
        lowp = any(a.dtype == torch.bfloat16 for a in args)
        for cast in ((False, True) if lowp else (True,)):
            a_ = tuple(a.float() for a in args) if cast else args
            got, ref = _tuple(kern(*a_)), _tuple(plain(*a_))
            again = _tuple(kern(*a_))
            check(all(torch.equal(x, y) for x, y in zip(got, again)),
                  f"{name} gave other bits on a second call at {_fused_shape(name, args)}")
            for i, (g_, r_) in enumerate(zip(got, ref)):
                tol = TOL_F32 if cast else tols[i]
                ok, e = _within(g_, r_, tol)
                if i in EXACT.get(name, ()):
                    check(torch.equal(g_, r_), f"{name} output {i} ({'f32' if cast else 'bf16'}) is "
                          f"not bit-equal to the plain version at {_fused_shape(name, args)}")
                check(ok and g_.shape == r_.shape and g_.dtype == r_.dtype,
                      f"{name} output {i} ({'f32' if cast else 'bf16'}) at {_fused_shape(name, args)}: "
                      f"max abs err {e} above {tol} of {float(r_.float().abs().max())}")
                errs, rels = (err32, rel32) if cast else (err16, rel16)
                errs[i] = max(errs[i], e)
                rels[i] = max(rels[i], e / max(float(r_.float().abs().max()), 1e-30))
                if not cast:
                    exact[i] = exact[i] and torch.equal(g_, r_)
        nbytes, f32, tc = _fused_cost(name, args)
        bnd, by = bound_ms(nbytes, f32, tc)
        row = dict(shape=_fused_shape(name, args), ms=device_ms(lambda: kern(*args)),
                   plain_ms=device_ms(lambda: plain(*args), reps=2, behind_sleep=False),
                   bound_ms=bnd, bound_by=by)
        check(row["ms"] >= bnd, f"{name} at {row['shape']}: {row['ms']} ms is below its bound {bnd}")
        lib = _library_call(name, args)
        if lib is not None:
            row["library_ms"] = device_ms(lib)
            if name == "attn_fused_bwd_a_dw":  # recorded, not held to a bound
                ref = _tuple(plain(*args))[0]
                row["library_rel_err"] = max_err(_library_dw(lib()), ref) / float(ref.abs().max())
        if library is not None:
            a32 = tuple(a.float() for a in args)
            row["f32_ms"] = device_ms(lambda: kern(*a32))
            b32, o32, _ = _fused_cost(name, a32)
            tot["f32_bytes"] += b32
            tot["f32_f32"] += o32
        for k, v in (("bytes", nbytes), ("f32", f32), ("tc", tc)):
            tot[k] += v
        for k in ("ms", "plain_ms", "library_ms", "f32_ms"):
            tot[k] += row.get(k, 0.0)
        rows.append(row)
    bnd, by = bound_ms(tot["bytes"], tot["f32"], tot["tc"])
    log(f"  {name}: {len(calls)} calls; kernel {tot['ms']:.4f} ms, plain {tot['plain_ms']:.2f} ms,"
        f" bound {bnd:.4f} ms ({by}; {tot['bytes'] / 1e6:.1f} MB, {tot['f32'] / 1e9:.1f} GFLOP FP32,"
        f" {tot['tc'] / 1e9:.1f} GFLOP bf16 tensor-core); max abs err per output bf16 "
        f"{['%.3g' % e for e in err16]} (bit-exact {exact}), f32 {['%.3g' % e for e in err32]}; "
        f"of the largest entry bf16 {['%.3g' % e for e in rel16]} (bounds {list(tols)}), f32 "
        f"{['%.3g' % e for e in rel32]} (bound {TOL_F32}); a second call bit-equal")
    out = dict(max_abs_err=max(err16 + err32), ms=tot["ms"], plain_ms=tot["plain_ms"],
               bound_ms=bnd, bound_by=by,
               library_ms=tot["library_ms"] if library is not None else None, library=library,
               err_bf16=err16, err_f32=err32, rel_err_bf16=rel16, rel_err_f32=rel32,
               bit_exact_bf16=exact, bytes=tot["bytes"],
               fp32_flop=tot["f32"], bf16_flop=tot["tc"], calls=len(calls), detail=rows)
    if library is not None:
        f32_bnd, f32_by = bound_ms(tot["f32_bytes"], tot["f32_f32"])
        out.update(f32_ms=tot["f32_ms"], f32_bound_ms=f32_bnd, f32_bound_by=f32_by)
        lib_err = [r["library_rel_err"] for r in rows if "library_rel_err" in r]
        if lib_err:
            out["library_rel_err"] = max(lib_err)
        log(f"    {library}: {tot['library_ms']:.4f} ms"
            + (f" (its error of the largest entry {max(lib_err):.3g})" if lib_err else "")
            + f"; FP32 path on the f32 inputs {tot['f32_ms']:.4f} ms (bound {f32_bnd:.4f}, "
            f"{f32_by})")
        for r in rows:
            log(f"    {r['shape']}: kernel {r['ms']:.4f} ms, bound {r['bound_ms']:.4f}, plain "
                f"{r['plain_ms']:.3f}, library {r['library_ms']:.4f}, f32 path {r['f32_ms']:.4f}")
    return out


# (B, H, W, C) off the tile grids: H != W, frames that are not multiples of
# the 8x8 tiles, channel counts that are not multiples of 8 or 16 (6, 70, 130,
# 18) or of 64 (24), past one 64- or 128-wide chunk; small frames make the
# tensor-core products split K over the offsets
RAGGED_FUSED = ((1, 13, 11, 6), (2, 9, 20, 70), (1, 17, 8, 130), (2, 10, 19, 18), (2, 21, 27, 24))
# B4-bwd-c's frames where one pixel collects both margins of an axis (H or W
# equal to 1) or one tile touches both edges (H and W below 11)
SMALL_BWD_C = ((1, 1, 1, 6), (2, 1, 13, 18), (1, 9, 1, 70), (2, 7, 10, 130), (1, 5, 3, 24),
               (3, 1, 1, 64))


def check_fused_ragged() -> dict:
    """(c) All four B4 kernels against their plain versions on RAGGED_FUSED,
    and B4-bwd-c also on SMALL_BWD_C, f32 and bf16, each called twice and
    held bit-equal to itself (dW on the plain version's dG; the outputs in
    EXACT bit-equal to the plain version)."""
    import torch

    from hoig_torch.ops import attn_fused as af

    gen = torch.Generator(device="cuda").manual_seed(9)
    randn = lambda *shape: torch.randn(*shape, device="cuda", generator=gen)
    worst: dict = {}  # (kernel, dtype) -> the largest error over the output's largest magnitude
    for b, h, w, c in RAGGED_FUSED + SMALL_BWD_C:
        for dtype in (torch.float32, torch.bfloat16):
            src = randn(b, h, w, c).to(dtype)
            w0s = (randn(25, c, 128) / (25 * c) ** 0.5).to(dtype)
            flow = torch.rand(b, h, w, 2, device="cuda", generator=gen) * 4.9 - 2.95
            fields = af.flow_fields(flow)
            fwd_args = (src, 0.1 * randn(b, h, w, 128), w0s, randn(128, 25) / 128 ** 0.5,
                        0.1 * randn(1, 25), *fields)
            attn = af.attn_fused_fwd(*fwd_args)[2]
            g_acc = randn(b, h, w, 128)
            dg = af._dg_reference(g_acc, *af.coeff_axes(*fields))
            cases = {"attn_fused_fwd": fwd_args,
                     "attn_fused_bwd_c": (src, *fields, attn, randn(b, h, w, c).to(dtype)),
                     "attn_fused_bwd_a_gsrc": (g_acc, *fields, w0s),
                     "attn_fused_bwd_a_dw": (src, dg)}
            if (b, h, w, c) in SMALL_BWD_C:
                cases = {"attn_fused_bwd_c": cases["attn_fused_bwd_c"]}
            for name, args in cases.items():
                got = _tuple(getattr(af, name)(*args))
                ref = _tuple(getattr(af, name + "_reference")(*args))
                again = _tuple(getattr(af, name)(*args))
                check(all(torch.equal(x, y) for x, y in zip(got, again)),
                      f"{name} gave other bits on a second call at {(b, h, w, c)} {dtype}")
                for i, (g_, r_) in enumerate(zip(got, ref)):
                    tol = TOL_F32 if dtype == torch.float32 else (
                        TOL_BF16 if (name, i) in (("attn_fused_fwd", 0), ("attn_fused_bwd_c", 0))
                        else TOL_F32 if name in ("attn_fused_bwd_a_gsrc", "attn_fused_bwd_a_dw")
                        else TOL_RESID)
                    ok, e = _within(g_, r_, tol)
                    check(ok, f"{name} output {i} differs at {(b, h, w, c)} {dtype}: {e}")
                    if i in EXACT.get(name, ()):
                        check(torch.equal(g_, r_), f"{name} output {i} is not bit-equal to the "
                              f"plain version at {(b, h, w, c)} {dtype}")
                    key = (name, str(dtype).replace("torch.", ""))
                    worst[key] = max(worst.get(key, 0.0), e / float(r_.float().abs().max()))
    log(f"  (c) ragged shapes {', '.join(map(str, RAGGED_FUSED))}, f32 and bf16: all four B4 "
        f"kernels agree with their plain versions and repeat their bits; B4-bwd-c also on "
        f"{', '.join(map(str, SMALL_BWD_C))}, its source gradient bit-equal throughout; worst "
        "error of the largest entry: " + ", ".join(f"{k} {d} {v:.3g}" for (k, d), v in sorted(worst.items())))
    return {f"{k} {d}": v for (k, d), v in worst.items()}


def shift_yardstick(layer_inputs, gen_shift) -> tuple[float, float]:
    """Device ms of the shift engine's ExtractorAttn on the fused path's own
    layer inputs, summed over the layers: its forward, and its backward
    (forward + backward less forward). Timed with events around each call,
    not queued ahead: the module launches many small kernels."""
    import torch

    fwd = bwd = 0.0
    for name, (src, tgt, flow) in layer_inputs:
        mod = gen_shift.get_submodule(name)
        s_, t_, f_ = (x.detach().clone() for x in (src, tgt, flow))
        with torch.inference_mode():
            f_ms = device_ms(lambda: mod(s_, t_, f_), reps=3, behind_sleep=False)
        s_.requires_grad_(True)
        t_.requires_grad_(True)
        cot = torch.ones_like(s_)
        fb_ms = device_ms(lambda: torch.autograd.backward(mod(s_, t_, f_), cot), reps=3,
                          behind_sleep=False)
        mod.zero_grad(set_to_none=True)
        fwd += f_ms
        bwd += max(fb_ms - f_ms, 0.0)
    return fwd, bwd


def engines_agree() -> dict:
    """(d) The fused and shift engines on the card in f32 (TF32 off), full
    width, 128 px, batch 1, one state dict: the ten outputs within the JAX
    package's bound for its engine comparison (rtol 2e-4, atol 2e-5,
    tests/test_models.py), and the gradients of a fixed scalar of them
    w.r.t. every weight, leaf by leaf, within the two bounds of the CPU
    tests' step comparisons (tests/test_torch_train.py): 2e-4 of the leaf's
    largest entry + 1e-2 of the largest gradient (the leaves whose gradient
    is 1e-2 to 1e-5 of the largest carry the slope of the outputs' last-bit
    differences), and 0.15 of the leaf's largest entry + 1e-6 of the largest
    gradient (what a missing or mis-signed path breaks in any leaf)."""
    import dataclasses

    import numpy as np
    import torch

    from hoig_torch.data.synthetic import synthetic_batch, synthetic_environment
    from hoig_torch.geometry.conditioning import ConditioningConfig
    from hoig_torch.train.model_api import batch_as_torch, flow_only
    from hoig_torch.train.trainer import TrainConfig, build_generator, generator_kwargs

    s = 128
    env = synthetic_environment(2, s, device="cuda")
    tables_np = env["tables_np"]
    tables_np.obj_tex = (np.random.RandomState(5).rand(*tables_np.obj_tex.shape) * 2 - 1).astype(
        np.float32)
    env = dict(env, tables=tables_np.as_torch("cuda"))
    batch = batch_as_torch(synthetic_batch(1, env["obj_verts"], image_size=s, seed=3), "cuda")
    flow = flow_only(batch, env, ConditioningConfig(image_size=s))
    kw = generator_kwargs({k: (None if v is None else v.clone()) for k, v in flow.items()},
                          batch["maskA"], batch["maskB"], True)
    cfg = TrainConfig(conv_dim=64, repeat_num=6, corner_engine="shift",
                      compute_dtype=torch.float32, remat=False)
    g_s = build_generator(cfg, device="cuda", seed=1)
    g_f = build_generator(dataclasses.replace(cfg, corner_engine="pallas"), device="cuda", seed=1)
    g_f.load_state_dict(g_s.state_dict())
    with torch.inference_mode():
        o_s, o_f = g_s(**kw), g_f(**kw)
    err = max(max_err(a, b) for a, b in zip(o_f, o_s))
    for i, (a, b) in enumerate(zip(o_f, o_s)):
        check(torch.allclose(a, b, rtol=2e-4, atol=2e-5),
              f"fused vs shift engine output {i}: max abs err {max_err(a, b)}")
    wgen = torch.Generator().manual_seed(7)
    weights = [torch.randn(o.shape, generator=wgen).cuda() for o in o_s]

    def grads(model):
        outs = model(**kw)
        scalar = sum((o.float() * w).sum() for o, w in zip(outs, weights))
        named = list(model.named_parameters())
        return dict(zip((n for n, _ in named), torch.autograd.grad(scalar, [p for _, p in named])))

    gr_s = grads(g_s)
    agree = grads_agree(grads(g_f), gr_s, "fused vs shift")
    log(f"  (d) engines agree, f32 128 px b1: outputs max abs err {err:.3g} (rtol 2e-4, atol 2e-5); "
        f"gradients w.r.t. {len(gr_s)} weight tensors worst {agree['grad_err_of_leaf_max']:.3g} of "
        f"a leaf's max (bound 0.15), {agree['grad_err_of_tree_max']:.3g} of the largest gradient "
        f"{agree['tree_max']:.3g} (bound 1e-2)")
    return dict(output_err=err, **agree)


def grads_agree(got: dict, ref: dict, label: str, slack: dict | None = None) -> dict:
    """Two gradients of every weight, leaf by leaf, within the two bounds of
    the CPU tests' step comparisons (see engines_agree), each widened by
    slack[leaf] when given; logs the three worst leaves and returns the worst
    errors and how many leaves are bit-equal."""
    import torch

    check(got.keys() == ref.keys(), f"{label}: gradients of other weights")
    tree_max = max(float(v.abs().max()) for v in ref.values())
    rows = []
    for name, r in ref.items():
        e, top = max_err(got[name], r), float(r.abs().max())
        extra = slack[name] if slack else 0.0
        check(bool(torch.isfinite(got[name]).all()), f"{label}: non-finite gradient of {name}")
        check(e <= 2e-4 * top + 1e-2 * tree_max + extra and e <= 0.15 * top + 1e-6 * tree_max + extra,
              f"gradient of {name}: {label} max abs err {e} (leaf max {top}, largest {tree_max}, "
              f"slack {extra})")
        rows.append((e / top if top > 1e-6 * tree_max else 0.0, e, top, name))
    rows.sort(reverse=True)
    for rel, e, top, name in rows[:3]:
        log(f"    {name}: max abs err {e:.3g}, {rel:.3g} of its largest entry {top:.3g}")
    return dict(grad_err_of_leaf_max=rows[0][0], grad_err_of_tree_max=max(r[1] for r in rows) / tree_max,
                tree_max=tree_max, bit_equal_leaves=sum(torch.equal(got[n], r) for n, r in ref.items()),
                leaves=len(ref))


def time_serving(gen, env, ccfg, batch, tcfg, expected: dict, n: int = 7) -> dict:
    """Host ms of n serving calls (conditioning, then generator) after two
    warm-up calls, each with its launches asserted and finite outputs."""
    import torch

    from hoig_torch.ops import _cuda
    from hoig_torch.train.model_api import flow_only, forward_only

    for _ in range(2):
        forward_only(gen, flow_only(batch, env, ccfg), batch, tcfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cond_ms, gen_ms = [], []
    for _ in range(n):
        _cuda.reset_launch_counts()
        t0 = time.perf_counter()
        flow = flow_only(batch, env, ccfg)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        outs = forward_only(gen, flow, batch, tcfg)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        check(_cuda.launch_counts() == expected,
              f"per-call launches {_cuda.launch_counts()} != {expected}")
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
    return serve


def fused_phase(env, ccfg, batch, gen_shift, tcfg_shift):
    """Phase 6 (see the module docstring). Returns (kernel results, the
    phase's numbers, a function that builds the profiler regions of the
    fused serving call and step). The phase frees its generator and training
    state before it returns, so that phase 7's memory peaks count the shift
    engine's alone; the returned function makes fresh ones for the profiler."""
    import dataclasses

    import torch

    from hoig_torch.models.generator import ExtractorAttn
    from hoig_torch.ops import _cuda
    from hoig_torch.train.model_api import flow_only, forward_only
    from hoig_torch.train.trainer import build_generator

    # (a) serving, from launch counters at 0, on the shift generator's weights
    tcfg = dataclasses.replace(tcfg_shift, corner_engine="pallas")
    gen = build_generator(tcfg, device="cuda", seed=0)
    gen.load_state_dict(gen_shift.state_dict())
    layer_inputs = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args, name=name: layer_inputs.append((name, args)))
        for name, m in gen.named_modules() if isinstance(m, ExtractorAttn)]
    rec = Recorder()
    with recording(rec):
        torch.cuda.synchronize()
        _cuda.reset_launch_counts()
        outs = forward_only(gen, flow_only(batch, env, ccfg), batch, tcfg)
        torch.cuda.synchronize()
        launches = _cuda.launch_counts()
    for h in hooks:
        h.remove()
    log(f"  (a) fused serving call launches: {launches}")
    check(launches == FUSED_LAUNCHES_PER_CALL,
          f"fused serving launches {launches} != {FUSED_LAUNCHES_PER_CALL}")
    check(all(torch.isfinite(o).all() for o in outs), "non-finite fused serving outputs")
    check(len(layer_inputs) == 9, f"{len(layer_inputs)} attention layers ran")
    results = {"attn_fused_fwd_tc": check_fused_kernel("attn_fused_fwd", rec.calls["attn_fused_fwd"])}
    del rec
    yard_fwd, yard_bwd = shift_yardstick(layer_inputs, gen_shift)
    log(f"  yardstick: the shift engine's ExtractorAttn on the same 9 layer inputs, forward "
        f"{yard_fwd:.3f} ms, backward {yard_bwd:.3f} ms")
    del layer_inputs
    log(f"  (e) fused serving call timing: {IMAGE} px, batch {BATCH}, bf16")
    serve = time_serving(gen, env, ccfg, batch, tcfg, FUSED_LAUNCHES_PER_CALL)

    # (b) one training step, remat off, from launch counters at 0
    log("  (b) fused training step: 256 px, batch 4, bf16, remat off")
    state, step = build_step(env, ccfg, train_config("pallas", remat=False))
    rec = Recorder()
    metrics, step_launches = recorded_step(state, step, batch, FUSED_LAUNCHES_PER_STEP, rec)
    for name in FUSED[1:]:
        check(len(rec.calls[name]) == 9, f"{name}: {len(rec.calls[name])} calls recorded")
        results[FUSED_BF16[name]] = check_fused_kernel(name, rec.calls[name])
    del rec
    for name in FUSED:
        r = results[FUSED_BF16[name]]
        r["launches"] = step_launches[FUSED_BF16[name]]
        r["yardstick_ms"] = yard_fwd if name == FUSED[0] else yard_bwd
        r["yardstick"] = ("shift-engine ExtractorAttn " +
                          ("forward" if name == FUSED[0] else "backward (all of it)"))

    ms, peak = timed_steps(state, step, batch, FUSED_LAUNCHES_PER_STEP, warm=3, n=6)
    med = statistics.median(ms)
    train = dict(step_ms=med, images_per_s=BATCH / (med / 1e3), peak_mem_mb=peak, steps=len(ms),
                 step_ms_all=ms, launches=step_launches, metrics=metrics)
    log(f"  (e) fused step {med:.2f} ms (median of {len(ms)}; {min(ms):.2f}-{max(ms):.2f}), "
        f"{train['images_per_s']:.2f} images/s, peak {peak:.0f} MiB")
    del state, step
    torch.cuda.empty_cache()

    # (b) the same first step (fresh weights from seed 0, same batch) three
    # times more: twice with remat off, then with the conv blocks and the
    # attention layers rematerialized. The recompute runs the same kernels on
    # the same inputs, but no two steps on the card need agree to the last
    # bit: the gathers (torch.gather, index_select) scatter-add their
    # gradients with float atomics in no fixed order, and bf16 activation
    # gradients carry such differences onward; in the leaves whose gradient
    # is zero up to rounding (a conv bias before a norm) they are all there
    # is. So the two remat-off steps measure that noise leaf by leaf, and the
    # remat step is held within grads_agree's bounds widened by three times
    # it (one sample of a difference of two runs, against another). cuDNN is
    # held to its deterministic algorithms for these steps, so that a
    # recompute under other memory pressure does not pick another
    # convolution algorithm
    def fresh_step_grads(**remat):
        state, step = build_step(env, ccfg, train_config("pallas", **remat))
        torch.backends.cudnn.deterministic = True
        try:
            counted_step(state, step, batch, True, FUSED_LAUNCHES_PER_STEP_REMAT
                         if remat.get("remat") else FUSED_LAUNCHES_PER_STEP)
        finally:
            torch.backends.cudnn.deterministic = False
        grads = {n: p.grad for n, p in state.g.named_parameters()}
        del state, step
        torch.cuda.empty_cache()
        return grads

    log("  (b) the fused step again, twice remat off, then with remat and remat_attn on")
    g_grads = fresh_step_grads(remat=False)
    g_again = fresh_step_grads(remat=False)
    noise = {n: max_err(g_again[n], r) for n, r in g_grads.items()}
    n_equal = sum(torch.equal(g_again[n], r) for n, r in g_grads.items())
    worst = max(noise, key=noise.get)
    log(f"  remat off twice: {n_equal} of {len(noise)} G gradient leaves bit-equal; largest "
        f"difference {noise[worst]:.3g} ({worst}, leaf max {float(g_grads[worst].abs().max()):.3g})")
    del g_again
    g_remat = fresh_step_grads(remat=True, remat_bottleneck=False, remat_attn=True)
    remat = grads_agree(g_remat, g_grads, "remat vs remat off",
                        slack={n: 3.0 * e for n, e in noise.items()})
    log(f"  remat step: launches {FUSED_LAUNCHES_PER_STEP_REMAT}; G gradients {remat['bit_equal_leaves']} "
        f"of {remat['leaves']} leaves bit-equal to the remat-off step's, worst "
        f"{remat['grad_err_of_leaf_max']:.3g} of a leaf's max, {remat['grad_err_of_tree_max']:.3g} of "
        f"the largest gradient")
    train["remat_attn"] = dict(remat, remat_off_twice_bit_equal_leaves=n_equal,
                               remat_off_twice_max_diff=noise[worst])
    del g_remat, g_grads

    # (c) ragged shapes; (d) the engines agree
    ragged = check_fused_ragged()
    agree = engines_agree()

    del gen
    torch.cuda.empty_cache()

    def regions() -> dict:
        gen = build_generator(tcfg, device="cuda", seed=0)
        gen.load_state_dict(gen_shift.state_dict())
        state, step = build_step(env, ccfg, train_config("pallas", remat=False))
        forward_only(gen, flow_only(batch, env, ccfg), batch, tcfg)  # warm-up
        counted_step(state, step, batch, True, FUSED_LAUNCHES_PER_STEP)
        return {
            "hoig_serve_fused": (
                lambda: forward_only(gen, flow_only(batch, env, ccfg), batch, tcfg), 2),
            "hoig_train_fused": (
                lambda: counted_step(state, step, batch, True, FUSED_LAUNCHES_PER_STEP), 1),
        }

    return results, dict(serving=serve, training=train, serving_launches=launches,
                         engines_agree=agree, ragged_rel_err=ragged), regions


# device kernel name -> operator class, first match wins
KERNEL_CLASSES = (
    ("hand-written kernels", ("combine_fwd_kernel", "combine_bwd_src_kernel", "combine_bwd_v_kernel",
                              "combine_bwd_src_tc_kernel", "combine_bwd_v_tc_kernel",
                              "raster_kernel", "gather_kernel", "conv5_kernel", "conv5_tc_kernel",
                              "fwd_pixel_kernel", "bwd_c_kernel", "bwd_c_gattn_kernel",
                              "fold_kernel", "dg_kernel", "dw_kernel", "dw_tc_kernel",
                              "slice_sum_kernel")),
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


def hand_written(by_name: dict, n: int) -> dict:
    """Device ms and launches per call or step of each hand-written kernel,
    by its function name as a whole word of the profiler's kernel name (so
    that dw_kernel does not count dw_tc_kernel's launches)."""
    out = {}
    for key in KERNEL_CLASSES[0][1]:
        pat = re.compile(rf"(?<![A-Za-z_]){key}(?![a-z_])")
        hits = [v for k, v in by_name.items() if pat.search(k)]
        if hits:
            out[key] = dict(ms=sum(v[0] for v in hits) / n / 1e3, count=sum(v[1] for v in hits) // n)
    return out


def profile_window(regions: dict, out_dir: Path) -> dict:
    """Device time by kernel over each region {name: (fn, calls)}, in ONE
    torch.profiler run (a second profiler in the same process lost its
    device events on this machine): the regions are told apart by the time
    ranges of their annotations, each closed after a synchronize."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for region, (fn, n) in regions.items():
            with record_function(region):
                for _ in range(n):
                    fn()
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
    for region, (_, n) in regions.items():
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
            f"{'call' if region.startswith('hoig_serve') else 'step'} ({total / n / 1e3 / wall:.0%}), "
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
                           kernels=table[:60], hand_written=hand_written(by_name, n))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=REPO / "build" / "chip_smoke",
                    help="directory for result.json, profile.txt and build.txt")
    cli = ap.parse_args()
    out_dir = cli.out
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
    (out_dir / "build.txt").write_text("\n".join(f"--- {k}\n{v}" for k, v in report.items()))
    for name, text in report.items():
        lines = [ln.strip() for ln in text.splitlines()
                 if "registers" in ln or "smem" in ln or "spill" in ln or "wgmma" in ln]
        log(f"  {name}: " + ("; ".join(lines[-8:]) if lines else text.strip()[:200]))
    log(f"[2] kernels built in {build_s:.1f} s")
    from hoig_torch.ops import attn_fused as af

    from hoig_torch.ops import local_combine as lc

    tiling = af.kernel_tiling()
    check(tiling == af.TILING, f"attn_fused.cu's tile constants {tiling} != TILING {af.TILING}")
    log(f"  attn_fused tile constants agree with hoig_torch/ops/attn_fused.py: {tiling}")
    tiling = lc.kernel_tiling()
    check(tiling == lc.TILING, f"local_combine.cu's tile constants {tiling} != TILING {lc.TILING}")
    log(f"  local_combine tile constants agree with hoig_torch/ops/local_combine.py: {tiling}")

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
    serve = time_serving(gen, env, ccfg, batch, tcfg, LAUNCHES_PER_CALL)

    # 6. the fused attention engine
    log(f"[6] fused attention engine (corner_engine 'pallas'): {IMAGE} px, batch {BATCH}, bf16, "
        "conv_dim 64, repeat 6, the shift generator's weights")
    fused_results, fused, fused_regions = fused_phase(env, ccfg, batch, gen, tcfg)
    results.update(fused_results)

    # 7. the training step (and 8. the profiler window)
    log(f"[7] training step: {IMAGE} px, batch {BATCH}, bf16, shift engine, conv_dim 64, repeat 6, "
        "PatchGAN-4, VGG19 loss, mask BCE")
    regions = {"hoig_serve": (lambda: forward_only(gen, flow_only(batch, env, ccfg), batch, tcfg), 2)}
    bwd_results, train, profile = training_phase(env, ccfg, batch, regions, fused_regions, out_dir)
    results.update(bwd_results)
    for path in ("serving", "training"):
        region = "hoig_serve_fused" if path == "serving" else "hoig_train_fused"
        fused[path]["device_ms"] = profile.get(region, {}).get("device_ms")
    del fused_regions
    # dG is built once per backward (by bwd-a-gsrc's entry point), dW runs on
    # the tensor cores, B4-bwd-c is bwd_c_kernel and bwd_c_gattn_kernel, and
    # only the gsrc projection folds through device memory: one launch each
    # per attention layer
    hw = profile.get("hoig_train_fused", {}).get("hand_written")
    want = {"dg_kernel": 9, "dw_tc_kernel": 9, "dw_kernel": 0, "bwd_c_kernel": 9,
            "bwd_c_gattn_kernel": 9, "fold_kernel": 9}
    if hw is None:
        log("  profiler: the fused step's launches by kernel not measured")
    else:
        got = {k: hw.get(k, {}).get("count", 0) for k in want}
        log(f"  profiler hoig_train_fused: launches per step {got}")
        check(got == want, f"fused step launches by kernel {got} != {want}")
    # the shift step's backward combines run on the tensor cores under bf16:
    # both sides of the R = 5 combine and dsrc of the R = 3 one, per layer
    hw = profile.get("hoig_train", {}).get("hand_written")
    want = {"combine_bwd_src_tc_kernel": 18, "combine_bwd_v_tc_kernel": 9,
            "combine_bwd_src_kernel": 0, "combine_bwd_v_kernel": 0, "combine_fwd_kernel": 18}
    if hw is None:
        log("  profiler: the shift step's launches by kernel not measured")
    else:
        got = {k: hw.get(k, {}).get("count", 0) for k in want}
        log(f"  profiler hoig_train: launches per step {got}")
        check(got == want, f"shift step launches by kernel {got} != {want}")

    # 9. report
    kernels = []
    for name, (src, replaces) in KERNELS.items():
        r = results[name]
        on_fused = name in FUSED_BF16.values()
        step_launches = fused["training"]["launches"] if on_fused else train["launches"]
        call_launches = fused["serving_launches"] if on_fused else launches
        row = dict(name=name, route="cuda", source=src, replaces=replaces,
                   launches=step_launches[name], launches_serving=call_launches.get(name, 0),
                   max_abs_err=r["max_abs_err"], ms=r["ms"],
                   plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                   library_ms=r["library_ms"])
        row.update({k: r[k] for k in ("library", "yardstick_ms", "yardstick", "f32_ms",
                                      "f32_bound_ms") if k in r})
        kernels.append(row)
    detail = dict(card=card, torch=torch.__version__, cuda=torch.version.cuda, build_s=build_s,
                  kernels=results, cpu_compare=cpu_cmp, serving=serve, training=train,
                  fused=fused, profile=profile)
    (out_dir / "result.json").write_text(json.dumps(detail, indent=1, default=str))
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
