"""Per-pixel weighted combination of bounded shifts, with its gradient.

    out[b, y, x, :] = sum_d  v[b, y, x, d] * src_pad[b, y + d // K, x + d % K, :]

with K = 2R + 1, the K^2 offsets row-major and `src_pad` padded by R on each
spatial side. The flow-guided attention's shift engine calls it twice per
layer (models/generator.py): R = 3 over the 128-wide projected field G, then
R = 5 over the edge-padded source.

`local_combine` is a `torch.autograd.Function`. On CUDA tensors its forward
and its backward launch the hand-written kernels of csrc/local_combine.cu
(`hoig_local_combine_fwd`, `_bwd_src`, `_bwd_v`); on CPU tensors the same
Function runs `local_combine_reference` and
`local_combine_backward_reference`, the plain loops the kernels are held
against. For a cotangent g of `out`:

    dsrc[b, qy, qx, :] = sum_d v[b, qy - d // K, qx - d % K, d] * g[b, qy - d // K, qx - d % K, :]
    dv[b, y, x, d]     = <g[b, y, x, :], src_pad[b, y + d // K, x + d % K, :]>,  0 for d >= K^2

Both sums are kept in f32 and rounded once to the input's dtype. (The TPU
kernel accumulated dsrc in the output's dtype, i.e. in bf16 under bf16; the
f32 sum is a numerical improvement, like the forward's.)
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from hoig_torch.ops import _cuda

_P = ctypes.c_void_p
_I = ctypes.c_int
# (in0, in1, out, b, h, w, c, d_cols, radius, is_bf16, stream) for all three entry points
_ARGTYPES = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]
_BWD_V_MAX_RADIUS = 5  # the bwd_v kernel keeps ceil(K^2 / 4) <= 31 sums per thread


def _acc_dtype(t: torch.Tensor) -> torch.dtype:
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def local_combine_reference(src_pad: torch.Tensor, v: torch.Tensor, radius: int) -> torch.Tensor:
    """Plain PyTorch loop: f32 accumulation in ascending d, output in src dtype."""
    b, hp, wp, c = src_pad.shape
    h, w = hp - 2 * radius, wp - 2 * radius
    k = 2 * radius + 1
    acc = _acc_dtype(src_pad)
    out = torch.zeros((b, h, w, c), dtype=acc, device=src_pad.device)
    for d in range(k * k):
        dy, dx = d // k, d % k
        sl = src_pad[:, dy : dy + h, dx : dx + w, :]
        out = out + sl.to(acc) * v[..., d : d + 1].to(acc)
    return out.to(src_pad.dtype)


@torch.no_grad()
def local_combine_backward_reference(src_pad: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
                                     radius: int, need_src: bool = True, need_v: bool = True):
    """Plain PyTorch loops for (dsrc, dv), in the kernels' order and precision:
    f32 sums in ascending d, one final cast. Either result is None when not
    asked for (then its input, `v` or `src_pad`, is not read and may be None)."""
    b, h, w, c = g.shape
    k = 2 * radius + 1
    acc = _acc_dtype(g)
    g32 = g.to(acc)
    dsrc = dv = None
    if need_src:
        dsrc = torch.zeros((b, h + 2 * radius, w + 2 * radius, c), dtype=acc, device=g.device)
        for d in range(k * k):
            dy, dx = d // k, d % k
            dsrc[:, dy : dy + h, dx : dx + w, :] += g32 * v[..., d : d + 1].to(acc)
        dsrc = dsrc.to(g.dtype)
    if need_v:
        dv = torch.zeros((b, h, w, k * k), dtype=acc, device=g.device)
        for d in range(k * k):
            dy, dx = d // k, d % k
            dv[..., d] = (g32 * src_pad[:, dy : dy + h, dx : dx + w, :].to(acc)).sum(-1)
        dv = dv.to(g.dtype)
    return dsrc, dv


def _launch(symbol: str, count_as: str, in0, in1, out, dims, radius: int) -> None:
    """Check what the kernels take, launch `symbol`, raise on a refused launch."""
    tensors = (in0, in1, out)
    _cuda.require_cuda(*tensors)
    if in0.dtype not in (torch.float32, torch.bfloat16) or any(t.dtype != in0.dtype for t in tensors):
        raise TypeError(f"{count_as} takes f32 or bf16 of one dtype, got "
                        f"{[str(t.dtype) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{count_as} needs contiguous NHWC tensors")
    b, h, w, c, d_cols = dims
    if c % 2:
        raise ValueError(f"{count_as} needs an even channel count, got {c}")
    fn = _cuda.kernel("local_combine", symbol, _ARGTYPES)
    err = fn(in0.data_ptr(), in1.data_ptr(), out.data_ptr(), b, h, w, c, d_cols, radius,
             int(in0.dtype == torch.bfloat16), _cuda.stream_ptr())
    _cuda.check(count_as, err)
    _cuda.count_launch(count_as)


def _forward(src_pad: torch.Tensor, v: torch.Tensor, radius: int) -> torch.Tensor:
    if src_pad.device.type == "cpu":
        return local_combine_reference(src_pad, v, radius)
    b, hp, wp, c = src_pad.shape
    h, w = hp - 2 * radius, wp - 2 * radius
    out = torch.empty((b, h, w, c), dtype=src_pad.dtype, device=src_pad.device)
    _launch("hoig_local_combine_fwd", "local_combine", src_pad, v, out,
            (b, h, w, c, v.shape[3]), radius)
    return out


def local_combine_backward(src_pad, v, g: torch.Tensor, radius: int, d_cols: int,
                           need_src: bool = True, need_v: bool = True):
    """(dsrc, dv) of `local_combine` for the cotangent g (B, H, W, C).

    dsrc (B, H+2R, W+2R, C) needs `v`; dv (B, H, W, d_cols) needs `src_pad`;
    a side that is not asked for is None and its input may be None. CUDA
    tensors go to the bwd_src / bwd_v kernels, CPU tensors to the plain loops."""
    g = g.contiguous()
    b, h, w, c = g.shape
    k2 = (2 * radius + 1) ** 2
    if g.device.type == "cpu":
        dsrc, dv = local_combine_backward_reference(src_pad, v, g, radius, need_src, need_v)
        if dv is not None and d_cols > k2:
            dv = torch.nn.functional.pad(dv, (0, d_cols - k2))
        return dsrc, dv
    dsrc = dv = None
    if need_src:
        dsrc = torch.empty((b, h + 2 * radius, w + 2 * radius, c), dtype=g.dtype, device=g.device)
        _launch("hoig_local_combine_bwd_src", "local_combine_bwd_src", g, v, dsrc,
                (b, h, w, c, v.shape[3]), radius)
    if need_v:
        if radius > _BWD_V_MAX_RADIUS:
            raise ValueError(f"the bwd_v kernel takes R <= {_BWD_V_MAX_RADIUS}, got {radius}")
        dv = torch.empty((b, h, w, d_cols), dtype=g.dtype, device=g.device)
        _launch("hoig_local_combine_bwd_v", "local_combine_bwd_v", src_pad, g, dv,
                (b, h, w, c, d_cols), radius)
    return dsrc, dv


class LocalCombine(torch.autograd.Function):
    """`local_combine` with its hand-written backward; keeps for the backward
    only the input each requested gradient reads."""

    @staticmethod
    def forward(ctx, src_pad: torch.Tensor, v: torch.Tensor, radius: int) -> torch.Tensor:
        need_src, need_v = ctx.needs_input_grad[:2]
        ctx.save_for_backward(src_pad if need_v else None, v if need_src else None)
        ctx.radius, ctx.d_cols = radius, v.shape[3]
        return _forward(src_pad, v, radius)

    @staticmethod
    @once_differentiable
    def backward(ctx, g: torch.Tensor):
        src_pad, v = ctx.saved_tensors
        need_src, need_v = ctx.needs_input_grad[:2]
        dsrc, dv = local_combine_backward(src_pad, v, g, ctx.radius, ctx.d_cols, need_src, need_v)
        return dsrc, dv, None


def local_combine(src_pad: torch.Tensor, v: torch.Tensor, radius: int) -> torch.Tensor:
    """out = sum_d v[..., d] * shift_d(src_pad); NHWC, (B, H, W, C); differentiable
    in `src_pad` and `v`.

    Args:
      src_pad: (B, H+2R, W+2R, C) float32 or bfloat16, contiguous.
      v: (B, H, W, D), D >= (2R+1)^2, same dtype; columns past (2R+1)^2 are
        ignored and get zero gradient.
      radius: R.
    """
    b, hp, wp, c = src_pad.shape
    h, w = hp - 2 * radius, wp - 2 * radius
    k2 = (2 * radius + 1) ** 2
    if v.shape[:3] != (b, h, w) or v.shape[3] < k2:
        raise ValueError(f"v {tuple(v.shape)} does not fit src_pad {tuple(src_pad.shape)}, R={radius}")
    return LocalCombine.apply(src_pad, v, radius)
