"""InstanceNorm with f32 statistics folded into a per-(sample, channel)
scale and offset, forward and backward (hoig_torch/csrc/instance_norm.cu).

    a = rstd * weight, b = bias - mean * a    (no weight: a = rstd, b = -mean * rstd)
    y = x * a + b

with mean and rstd = (var + eps)^-1/2 of each sample's channel over its H x
W pixels, in f32. Two routes, by device:

  * CPU tensors: the plain PyTorch version, `FoldedStats` (the folded
    statistics as an autograd Function with a hand-written backward) and
    the apply `x * a + b` in the compute dtype, with a and b rounded to it.
  * CUDA tensors: `InstanceNormFn`, whose forward is two kernel launches
    (`norm_forward`: the statistics' per-chunk partials, then the apply,
    which combines them; a recompute's kept pair takes the apply alone,
    `norm_apply`) and whose backward is three (`norm_backward`: the sums of
    dy and dy (x - mean), the coefficients with the weight and bias
    gradients, then dx). The kernels take the statistics in f64 and round
    them once to f32; y and dx are computed in f32 and rounded once to the
    compute dtype. `norm_*_reference` are the kernels' arithmetic in plain
    PyTorch (the statistics in f32, as FoldedStats takes them), which
    `InstanceNormFn` runs on CPU tensors.

Both routes count the statistics reductions run and the pairs handed to a
recompute (`stats_counts`: "computed", "kept"), and each hands a computed
pair to `keep` (models/layers.py keep_stats records it for the recompute).
x is channels_last or contiguous NCHW, f32 or bf16; the kernels take nothing
else and raise.
"""

from __future__ import annotations

import collections
import ctypes

import torch
from torch.autograd.function import once_differentiable

from hoig_torch.ops import _cuda

# statistics reductions run ("computed") and pairs handed to a recompute
# ("kept"), since the last reset: the tests and chip_smoke.py read them
_STATS = collections.Counter()


def stats_counts() -> dict:
    return dict(_STATS)


def reset_stats_counts() -> None:
    _STATS.clear()


class FoldedStats(torch.autograd.Function):
    """InstanceNorm's folded f32 statistics of x (B, C, H, W): a = rstd *
    weight, b = bias - mean * a (weight and bias None: a = rstd, b = -mean *
    rstd), each (B, C, 1, 1), with rstd = (var + eps)^-1/2 over H, W.

    With `kept` (a pair that an earlier call computed on the same values)
    it returns that pair and reduces nothing. Either way it saves x and the
    weight for the backward, so that a checkpoint's recompute saves what
    the original forward saved; mean and rstd stay on the original call's
    node, out of the checkpoint's reach."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps: float, kept):
        if kept is None:
            var, mean = torch.var_mean(x.float(), dim=(2, 3), correction=0, keepdim=True)
            rstd = torch.rsqrt(var + eps)
            a, b = rstd, -mean * rstd
            if weight is not None:
                scale = weight[None, :, None, None]
                a = a * scale
                b = b * scale + bias[None, :, None, None]
            # detached: rstd itself is the output a when there is no weight
            ctx.mean, ctx.rstd = mean, rstd.detach()
            _STATS["computed"] += 1
        else:
            a, b = (t.detach() for t in kept)
            _STATS["kept"] += 1
        ctx.save_for_backward(x, weight)
        return a, b

    @staticmethod
    @once_differentiable
    def backward(ctx, ga, gb):
        x, weight = ctx.saved_tensors
        mean, rstd = ctx.mean, ctx.rstd
        # the gradient of rstd, through a0 = rstd and b0 = -mean * rstd
        g_rstd = ga - gb * mean
        g_weight = g_bias = None
        if weight is not None:
            g_weight = (g_rstd * rstd).sum(dim=(0, 2, 3))
            g_bias = gb.sum(dim=(0, 2, 3))
            scale = weight[None, :, None, None]
            g_rstd, gb = g_rstd * scale, gb * scale
        # then to x: d rstd / d var = -rstd^3 / 2, d var / dx = 2 (x - mean) / n
        # and d mean / dx = 1 / n, so gx = k1 x + k0
        n = x.shape[2] * x.shape[3]
        k1 = g_rstd * (rstd.pow(3) * (-1.0 / n))
        k0 = torch.addcmul(k1 * mean, gb, rstd, value=1.0 / n).neg()
        return torch.addcmul(k0, x, k1).to(x.dtype), g_weight, g_bias, None, None


# ------------------------------------------------------------ plain versions


def _bc(t: torch.Tensor) -> torch.Tensor:
    """(B, C) -> (B, C, 1, 1)."""
    return t[:, :, None, None]


def norm_stats_reference(x, weight, bias, eps: float):
    """(a, b, mean, rstd), each (B, C) f32: FoldedStats' statistics."""
    var, mean = torch.var_mean(x.float(), dim=(2, 3), correction=0)
    rstd = torch.rsqrt(var + eps)
    a, b = rstd, -mean * rstd
    if weight is not None:
        a = a * weight
        b = b * weight + bias
    return a, b, mean, rstd


def norm_apply_reference(x, a, b):
    """y = x * a + b in f32, rounded once to x's dtype."""
    return (x.float() * _bc(a) + _bc(b)).to(x.dtype)


def norm_backward_reference(x, dy, weight, a, mean, rstd):
    """(dx, dweight, dbias) of y = x * a + b, a and b the folded statistics
    (dweight and dbias None without a weight): FoldedStats' backward and
    the apply's, merged into dx = dy a + (x k1 + k0), in f32 and rounded
    once to x's dtype."""
    n = x.shape[2] * x.shape[3]
    xf, g = x.float(), dy.float()
    s1 = g.sum(dim=(2, 3))
    s2 = (g * (xf - _bc(mean))).sum(dim=(2, 3))  # = sum(g x) - s1 mean
    g_weight = g_bias = None
    if weight is not None:
        g_weight = (s2 * rstd).sum(0)
        g_bias = s1.sum(0)
        s1, s2 = s1 * weight, s2 * weight
    k1 = s2 * (rstd * rstd * rstd * (-1.0 / n))
    k0 = -(k1 * mean + s1 * rstd * (1.0 / n))
    dx = g * _bc(a) + (xf * _bc(k1) + _bc(k0))
    return dx.to(x.dtype), g_weight, g_bias


# ------------------------------------------------------------ the kernels

_P = ctypes.c_void_p
_I = ctypes.c_int
# stats: x, part (f64), b, n, c, chunk, channels_last, bf16, stream
_STATS_ARGS = [_P] * 2 + [_I] * 6 + [_P]
# apply: x, y, part (f64), weight, bias, eps, a, offset, mean, rstd, b, n, c, chunk,
# channels_last, bf16, stream
_APPLY_ARGS = [_P] * 5 + [ctypes.c_float] + [_P] * 4 + [_I] * 6 + [_P]
# bwd_sums: x, dy, mean, part, b, n, c, chunk, channels_last, bf16, stream
_BWD_SUMS_ARGS = [_P] * 4 + [_I] * 6 + [_P]
# bwd_coef: part, mean, rstd, weight, k, gw, gb, b, n, c, chunk, stream
_BWD_COEF_ARGS = [_P] * 7 + [_I] * 4 + [_P]
# bwd_dx: x, dy, a, k, dx, b, n, c, chunk, channels_last, bf16, stream
_BWD_DX_ARGS = [_P] * 5 + [_I] * 6 + [_P]

_SMS = 132  # the H100's SMs
# the kernels' block geometry (instance_norm.cu): channels_last, kLanes
# threads across kLanes * VEC channels and kRows pixels; NCHW, a warp a
# channel, kWarps channels a block, its lanes across 32 * VEC pixels
_LANES, _ROWS, _WARPS = 8, 32, 8
_BLOCKS = 8 * _SMS  # a chunking aims at one wave of 8 blocks on each SM
_MAX_CHUNKS = 32  # partials a channel's apply and coefficients add up


def plan(b: int, c: int, n: int, channels_last: bool, itemsize: int) -> int:
    """The pixels a block covers (the chunk) for B samples of n pixels and c
    channels: the fewest chunks, a power of two and at most _MAX_CHUNKS a
    sample, that give _BLOCKS blocks, each a whole number of the block's
    pixel steps. Depends on the shape alone, so every run sums in the same
    order."""
    vec = 16 // itemsize
    if channels_last:
        groups, step = -(-c // (_LANES * vec)), _ROWS
    else:
        groups, step = -(-c // _WARPS), 32 * vec
    steps = -(-n // step)
    q = 1
    while q < min(steps, _MAX_CHUNKS) and b * groups * q < _BLOCKS:
        q *= 2
    return -(-steps // q) * step


def _layout(x: torch.Tensor) -> int:
    """1 for channels_last, 0 for contiguous NCHW; raises for anything else."""
    if x.is_contiguous():
        return 0
    if x.is_contiguous(memory_format=torch.channels_last):
        return 1
    raise ValueError(f"instance_norm takes channels_last or contiguous NCHW, got strides "
                     f"{x.stride()} for shape {tuple(x.shape)}")


def _check_input(x: torch.Tensor) -> int:
    _cuda.require_cuda(x)
    if x.dim() != 4:
        raise ValueError(f"instance_norm takes (B, C, H, W), got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"instance_norm takes f32 or bf16, got {x.dtype}")
    b, c, h, w = x.shape
    if min(b, c, h, w) < 1 or h * w > 1 << 24 or b > 65535:
        raise ValueError(f"instance_norm: unsupported shape {tuple(x.shape)}")
    return _layout(x)


def _check_params(x: torch.Tensor, *params) -> None:
    for t in params:
        if t is None:
            continue
        if t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"instance_norm: parameters must be contiguous f32 on {x.device}, "
                             f"got {t.dtype} on {t.device}")


def _geometry(x: torch.Tensor, cl: int):
    b, c, h, w = x.shape
    n = h * w
    chunk = plan(b, c, n, bool(cl), x.element_size())
    return b, n, c, chunk, -(-n // chunk)


def _launch(symbol: str, count_as: str, argtypes, args) -> None:
    fn = _cuda.kernel("instance_norm", symbol, argtypes)
    _cuda.check("instance_norm", fn(*args, _cuda.stream_ptr()), count_as)
    _cuda.count_launch(count_as)


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def norm_forward(x, weight, bias, eps: float):
    """(y, st): y = x * a + b in x's dtype and layout; st (4, B, C) f32, the
    planes a, b, mean and rstd. On the card two launches
    (`inorm_stats_kernel`, `inorm_apply_kernel`; counters `inorm_stats`,
    `inorm_apply`)."""
    if x.device.type == "cpu":
        st = torch.stack(norm_stats_reference(x, weight, bias, eps))
        return norm_apply_reference(x, st[0], st[1]), st
    cl = _check_input(x)
    if (weight is None) != (bias is None):
        raise ValueError("instance_norm: weight and bias come together")
    _check_params(x, weight, bias)
    b, n, c, chunk, q = _geometry(x, cl)
    bf16 = int(x.dtype == torch.bfloat16)
    part = torch.empty(2 * b * q * c, dtype=torch.float64, device=x.device)
    st = torch.empty((4, b, c), dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    _launch("hoig_inorm_stats", "inorm_stats", _STATS_ARGS,
            [x.data_ptr(), part.data_ptr(), b, n, c, chunk, cl, bf16])
    _launch("hoig_inorm_apply", "inorm_apply", _APPLY_ARGS,
            [x.data_ptr(), y.data_ptr(), part.data_ptr(), _ptr(weight), _ptr(bias), eps]
            + [p.data_ptr() for p in st] + [b, n, c, chunk, cl, bf16])
    return y, st


def norm_apply(x, a, b):
    """y = x * a + b (a, b (B, C) f32) in x's dtype and layout: a
    recompute's apply with its kept pair. On the card one launch of
    `inorm_apply_kernel` (counter `inorm_apply`), bit-equal to the apply
    that `norm_forward` ran with the same pair."""
    if x.device.type == "cpu":
        return norm_apply_reference(x, a, b)
    cl = _check_input(x)
    bb, n, c, chunk, _ = _geometry(x, cl)
    for t in (a, b):
        if t.shape != (bb, c):
            raise ValueError(f"instance_norm: a kept pair of shape {tuple(t.shape)} for an "
                             f"input of shape {tuple(x.shape)}")
    _check_params(x, a, b)
    y = torch.empty_like(x)
    _launch("hoig_inorm_apply", "inorm_apply", _APPLY_ARGS,
            [x.data_ptr(), y.data_ptr(), None, None, None, 0.0, a.data_ptr(), b.data_ptr(), None,
             None, bb, n, c, chunk, cl, int(x.dtype == torch.bfloat16)])
    return y


def norm_backward(x, dy, weight, a, mean, rstd):
    """(dx, dweight, dbias) (dweight and dbias None without a weight); dx
    in x's dtype and layout. On the card three launches
    (`inorm_bwd_sums_kernel`, `inorm_bwd_coef_kernel`,
    `inorm_bwd_dx_kernel`; counter `inorm_backward`). a, mean and rstd are
    (B, C) f32, as norm_forward made them."""
    if x.device.type == "cpu":
        return norm_backward_reference(x, dy, weight, a, mean, rstd)
    cl = _check_input(x)
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"instance_norm: gradient {dy.dtype} {tuple(dy.shape)} for an input "
                         f"{x.dtype} {tuple(x.shape)}")
    dy = dy.contiguous(memory_format=torch.channels_last if cl else torch.contiguous_format)
    _check_params(x, weight, a, mean, rstd)
    b, n, c, chunk, q = _geometry(x, cl)
    bf16 = int(x.dtype == torch.bfloat16)
    part = torch.empty(2 * b * q * c, dtype=torch.float32, device=x.device)
    k = torch.empty((2, b, c), dtype=torch.float32, device=x.device)
    gw = gb = None
    if weight is not None:
        gw = torch.empty(c, dtype=torch.float32, device=x.device)
        gb = torch.empty(c, dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    _launch("hoig_inorm_bwd_sums", "inorm_backward", _BWD_SUMS_ARGS,
            [x.data_ptr(), dy.data_ptr(), mean.data_ptr(), part.data_ptr(), b, n, c, chunk, cl,
             bf16])
    _launch("hoig_inorm_bwd_coef", "inorm_backward", _BWD_COEF_ARGS,
            [part.data_ptr(), mean.data_ptr(), rstd.data_ptr(), _ptr(weight), k.data_ptr(),
             _ptr(gw), _ptr(gb), b, n, c, chunk])
    _launch("hoig_inorm_bwd_dx", "inorm_backward", _BWD_DX_ARGS,
            [x.data_ptr(), dy.data_ptr(), a.data_ptr(), k.data_ptr(), dx.data_ptr(), b, n, c,
             chunk, cl, bf16])
    return dx, gw, gb


class InstanceNormFn(torch.autograd.Function):
    """y = x * a + b with the folded statistics computed here (or, with
    `kept`, a recompute's pair taken as it is), forward and backward by
    norm_forward / norm_apply and norm_backward: the kernels on the card,
    their plain versions on the CPU.

    Like FoldedStats, it saves x and the weight in both cases, so that a
    checkpoint's recompute saves what the original forward saved, and keeps
    a, mean and rstd on the original call's node; `keep(a, b)` receives a
    computed pair."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps: float, kept, keep):
        if kept is None:
            y, st = norm_forward(x, weight, bias, eps)
            ctx.stats = (st[0], st[2], st[3])
            if keep is not None:
                keep(st[0], st[1])
            _STATS["computed"] += 1
        else:
            y = norm_apply(x, *(t.detach() for t in kept))
            ctx.stats = None
            _STATS["kept"] += 1
        ctx.save_for_backward(x, weight)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, gy):
        if ctx.stats is None:
            raise RuntimeError("a recompute's InstanceNorm node has no statistics to "
                               "differentiate through")
        x, weight = ctx.saved_tensors
        dx, gw, gb = norm_backward(x, gy, weight, *ctx.stats)
        return dx, gw, gb, None, None, None


def instance_norm(x, weight, bias, eps: float, compute_dtype: torch.dtype, kept=None,
                  keep=None) -> torch.Tensor:
    """InstanceNorm of x (B, C, H, W) in `compute_dtype`, weight and bias
    (C,) f32 or both None. `kept`: a recompute's (a, b) to apply instead of
    reducing x again; `keep(a, b)`: receives a computed pair.

    CPU tensors take the plain version (FoldedStats, then x * a + b with a
    and b rounded to the compute dtype); CUDA tensors take InstanceNormFn
    on x in the compute dtype (the kernels: y = x * a + b in f32, rounded
    once), or raise."""
    if x.device.type == "cpu":
        a, b = FoldedStats.apply(x, weight, bias, eps, kept)
        if keep is not None:
            keep(a, b)
        cd = compute_dtype
        return x.to(cd) * a.to(cd) + b.to(cd)
    return InstanceNormFn.apply(x.to(compute_dtype), weight, bias, eps, kept, keep)
