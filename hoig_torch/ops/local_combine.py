"""Per-pixel weighted combination of bounded shifts, with its gradient.

    out[b, y, x, :] = sum_d  v[b, y, x, d] * src_pad[b, y + d // K, x + d % K, :]

with K = 2R + 1, the K^2 offsets row-major and `src_pad` padded by R on each
spatial side. The flow-guided attention's shift engine calls it twice per
layer (models/generator.py): R = 3 over the 128-wide projected field G, then
R = 5 over the edge-padded source.

`local_combine` is a `torch.autograd.Function`. On CUDA tensors its forward
and its backward launch the hand-written kernels of csrc/local_combine.cu;
on CPU tensors the same Function runs `local_combine_reference` and
`local_combine_backward_reference`, the plain loops the kernels are held
against. For a cotangent g of `out`:

    dsrc[b, qy, qx, :] = sum_d v[b, qy - d // K, qx - d % K, d] * g[b, qy - d // K, qx - d % K, :]
    dv[b, y, x, d]     = <g[b, y, x, :], src_pad[b, y + d // K, x + d % K, :]>,  0 for d >= K^2

Both sums are kept in f32 and rounded once to the input's dtype. (The TPU
kernel accumulated dsrc in the output's dtype, i.e. in bf16 under bf16; the
f32 sum is a numerical improvement, like the forward's.)

Both directions pick their entry points by dtype. bf16 runs the forward
and both gradients as banded tile products on the tensor cores
(`hoig_local_combine_fwd_tc`, `_bwd_src_tc`, `_bwd_v_tc`, counted as
`local_combine_tc`, `local_combine_bwd_src_tc` and `local_combine_bwd_v_tc`;
R in 1..5; the forward's source window arrives by TMA where `fwd_staging`
says so); f32 the FP32 kernels (`hoig_local_combine_fwd`, `_bwd_src`,
`_bwd_v`, counted as `local_combine`, `local_combine_bwd_src`,
`local_combine_bwd_v`), which repeat the plain loops' order and refuse
bf16. A bf16 call that the tensor-core kernels cannot take raises; nothing
falls back.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from hoig_torch.ops import _cuda

_P = ctypes.c_void_p
_I = ctypes.c_int
_BWD_V_MAX_RADIUS = 5  # the FP32 bwd_v kernel keeps ceil(K^2 / 4) <= 31 sums per thread
# The tensor-core kernels' tile constants (csrc/local_combine.cu, reported
# by hoig_local_combine_tiling): the tile edge, bwd_v's channels per stage
# and its largest cluster of channel splits, bwd_src's channels per block,
# the largest radius the kernels are built for, the forward's channels per
# stage.
TILING = dict(tile=8, v_slab=64, v_max_splits=8, src_channels=128, max_radius=5, fwd_slab=64)
_SMS = 132  # streaming multiprocessors of an H100 SXM


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


def _launch(symbol: str, count_as: str, in0, in1, out, dims, radius: int, tail=None) -> None:
    """Check what the kernels take, launch `symbol`, raise on a refused launch.

    The entry points take (in0, in1, out, b, h, w, c, d_cols, radius, *tail,
    stream); `tail` is the bf16 flag by default (the FP32 entry points refuse
    1), nothing for bwd_src_tc, the channel splits for bwd_v_tc, and the
    channel splits and the TMA flag for fwd_tc."""
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
    if tail is None:
        tail = (int(in0.dtype == torch.bfloat16),)
    fn = _cuda.kernel("local_combine", symbol, [_P, _P, _P] + [_I] * (6 + len(tail)) + [_P])
    err = fn(in0.data_ptr(), in1.data_ptr(), out.data_ptr(), b, h, w, c, d_cols, radius, *tail,
             _cuda.stream_ptr())
    _cuda.check("local_combine", err, count_as)
    _cuda.count_launch(count_as)


def kernel_tiling() -> dict:
    """The tile constants as the built local_combine library reports them
    (`hoig_local_combine_tiling`), under TILING's keys. Needs the card's build."""
    fn = _cuda.kernel("local_combine", "hoig_local_combine_tiling",
                      [ctypes.POINTER(ctypes.c_int), ctypes.c_int])
    buf = (ctypes.c_int * len(TILING))()
    n = fn(buf, len(TILING))
    if n != len(TILING):
        raise RuntimeError(f"local_combine reports {n} tile constants, TILING has {len(TILING)}")
    return dict(zip(TILING, buf))


def _channel_splits(b: int, h: int, w: int, c: int, slab: int, most: int) -> int:
    """The smallest power of two of channel splits whose tiles x splits
    blocks give 95% of the SMs a block, at most the slab count and `most`."""
    edge = TILING["tile"]
    tiles = b * -(-h // edge) * -(-w // edge)
    cap = min(most, -(-c // slab))
    splits = 1
    while splits < cap and tiles * splits < 0.95 * _SMS:
        splits *= 2
    return min(splits, cap)


def bwd_v_splits(b: int, h: int, w: int, c: int) -> int:
    """Channel splits of the tensor-core bwd_v: the blocks of one 8x8 tile
    form a cluster of this many, each summing a contiguous range of the
    64-channel slabs, and the cluster adds their partial bands in rank
    order. The smallest power of two whose tiles x splits blocks give 95%
    of the SMs a block, at most the slab count and the cluster limit (on an
    H100, one block per SM with more slabs each ran faster than two per SM
    with fewer: the longer a block's pipeline of slabs, the more of its
    staging overlaps). It counts the kernel's tiling (TILING); if the copy
    parts from the kernel's, only the speed suffers."""
    return _channel_splits(b, h, w, c, TILING["v_slab"], TILING["v_max_splits"])


def fwd_splits(b: int, h: int, w: int, c: int) -> int:
    """Channel splits of the tensor-core forward: each of a tile's blocks
    computes the output channels of a contiguous range of the 64-channel
    slabs (independent: no reduction), chosen as bwd_v_splits chooses (2 at
    32x32, where the 64 tiles alone leave half the card idle)."""
    return _channel_splits(b, h, w, c, TILING["fwd_slab"], c)


def fwd_staging(src_pad: torch.Tensor) -> str:
    """How the tensor-core forward stages the source window of a bf16
    `src_pad`: "tma" (one tile load per 8 channels; TMA needs 16-byte
    strides and base, so C % 8 == 0 and a 16-byte aligned tensor) or
    "elementwise" (each thread copies its values). Decided by shape and
    address before the launch."""
    aligned = src_pad.shape[3] % 8 == 0 and src_pad.data_ptr() % 16 == 0
    return "tma" if aligned else "elementwise"


def _check_tc_radius(radius: int) -> None:
    if not 1 <= radius <= TILING["max_radius"]:
        raise ValueError(f"the tensor-core kernels take R in 1..{TILING['max_radius']}, got {radius}")


def _forward(src_pad: torch.Tensor, v: torch.Tensor, radius: int) -> torch.Tensor:
    """out of `local_combine`: the plain loop on CPU tensors; on CUDA the
    tensor-core kernel under bf16 (R in 1..5, else this raises) and the FP32
    kernel under f32."""
    if src_pad.device.type == "cpu":
        return local_combine_reference(src_pad, v, radius)
    b, hp, wp, c = src_pad.shape
    h, w = hp - 2 * radius, wp - 2 * radius
    out = torch.empty((b, h, w, c), dtype=src_pad.dtype, device=src_pad.device)
    if src_pad.dtype == torch.bfloat16:
        _check_tc_radius(radius)
        k2 = (2 * radius + 1) ** 2
        # the kernel copies coefficient rows as they lie: exactly K^2 columns
        vk = v if v.shape[3] == k2 else v[..., :k2].contiguous()
        tma = int(fwd_staging(src_pad) == "tma")
        _launch("hoig_local_combine_fwd_tc", "local_combine_tc", src_pad, vk, out,
                (b, h, w, c, k2), radius, tail=(fwd_splits(b, h, w, c), tma))
    else:
        _launch("hoig_local_combine_fwd", "local_combine", src_pad, v, out,
                (b, h, w, c, v.shape[3]), radius)
    return out


def local_combine_backward(src_pad, v, g: torch.Tensor, radius: int, d_cols: int,
                           need_src: bool = True, need_v: bool = True):
    """(dsrc, dv) of `local_combine` for the cotangent g (B, H, W, C).

    dsrc (B, H+2R, W+2R, C) needs `v`; dv (B, H, W, d_cols) needs `src_pad`;
    a side that is not asked for is None and its input may be None. CPU
    tensors go to the plain loops; CUDA tensors to the tensor-core kernels
    under bf16 (R in 1..5, else this raises) and to the FP32 kernels under
    f32."""
    g = g.contiguous()
    b, h, w, c = g.shape
    k2 = (2 * radius + 1) ** 2
    if g.device.type == "cpu":
        dsrc, dv = local_combine_backward_reference(src_pad, v, g, radius, need_src, need_v)
        if dv is not None and d_cols > k2:
            dv = torch.nn.functional.pad(dv, (0, d_cols - k2))
        return dsrc, dv
    tc = g.dtype == torch.bfloat16
    if tc:
        _check_tc_radius(radius)
    dsrc = dv = None
    if need_src:
        dsrc = torch.empty((b, h + 2 * radius, w + 2 * radius, c), dtype=g.dtype, device=g.device)
        if tc:  # the kernel stages coefficient rows as they lie: exactly K^2 columns
            vk = v if v.shape[3] == k2 else v[..., :k2].contiguous()
            _launch("hoig_local_combine_bwd_src_tc", "local_combine_bwd_src_tc", g, vk, dsrc,
                    (b, h, w, c, k2), radius, tail=())
        else:
            _launch("hoig_local_combine_bwd_src", "local_combine_bwd_src", g, v, dsrc,
                    (b, h, w, c, v.shape[3]), radius)
    if need_v:
        dv = torch.empty((b, h, w, d_cols), dtype=g.dtype, device=g.device)
        dims = (b, h, w, c, d_cols)
        if tc:
            _launch("hoig_local_combine_bwd_v_tc", "local_combine_bwd_v_tc", src_pad, g, dv, dims,
                    radius, tail=(bwd_v_splits(b, h, w, c),))
        else:
            if radius > _BWD_V_MAX_RADIUS:
                raise ValueError(f"the bwd_v kernel takes R <= {_BWD_V_MAX_RADIUS}, got {radius}")
            _launch("hoig_local_combine_bwd_v", "local_combine_bwd_v", src_pad, g, dv, dims, radius)
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
