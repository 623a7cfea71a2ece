"""Per-pixel weighted combination of bounded shifts (forward).

    out[b, y, x, :] = sum_d  v[b, y, x, d] * src_pad[b, y + d // K, x + d % K, :]

with K = 2R + 1, the K^2 offsets row-major and `src_pad` padded by R on each
spatial side. The flow-guided attention's shift engine calls it twice per
layer (models/generator.py): R = 3 over the 128-wide projected field G, then
R = 5 over the edge-padded source.

On CUDA tensors `local_combine` launches the hand-written kernel
(csrc/local_combine.cu); on CPU tensors it runs `local_combine_reference`,
the plain loop the kernel is held against.
"""

from __future__ import annotations

import ctypes

import torch

from hoig_torch.ops import _cuda

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]


def local_combine_reference(src_pad: torch.Tensor, v: torch.Tensor, radius: int) -> torch.Tensor:
    """Plain PyTorch loop: f32 accumulation in ascending d, output in src dtype."""
    b, hp, wp, c = src_pad.shape
    h, w = hp - 2 * radius, wp - 2 * radius
    k = 2 * radius + 1
    out = torch.zeros((b, h, w, c), dtype=torch.float32, device=src_pad.device)
    for d in range(k * k):
        dy, dx = d // k, d % k
        sl = src_pad[:, dy : dy + h, dx : dx + w, :]
        out = out + sl.float() * v[..., d : d + 1].float()
    return out.to(src_pad.dtype)


def local_combine(src_pad: torch.Tensor, v: torch.Tensor, radius: int) -> torch.Tensor:
    """out = sum_d v[..., d] * shift_d(src_pad); NHWC, (B, H, W, C).

    Args:
      src_pad: (B, H+2R, W+2R, C) float32 or bfloat16, contiguous.
      v: (B, H, W, D), D >= (2R+1)^2, same dtype; columns past (2R+1)^2 are
        ignored.
      radius: R.
    """
    b, hp, wp, c = src_pad.shape
    h, w = hp - 2 * radius, wp - 2 * radius
    k2 = (2 * radius + 1) ** 2
    if v.shape[:3] != (b, h, w) or v.shape[3] < k2:
        raise ValueError(f"v {tuple(v.shape)} does not fit src_pad {tuple(src_pad.shape)}, R={radius}")
    if src_pad.device.type == "cpu":
        return local_combine_reference(src_pad, v, radius)
    _cuda.require_cuda(src_pad, v)
    if src_pad.dtype not in (torch.float32, torch.bfloat16) or v.dtype != src_pad.dtype:
        raise TypeError(f"local_combine takes f32 or bf16 of one dtype, got {src_pad.dtype}, {v.dtype}")
    if not (src_pad.is_contiguous() and v.is_contiguous()):
        raise ValueError("local_combine needs contiguous NHWC inputs")
    if c % 2:
        raise ValueError(f"local_combine needs an even channel count, got {c}")
    out = torch.empty((b, h, w, c), dtype=src_pad.dtype, device=src_pad.device)
    fn = _cuda.kernel("local_combine", "hoig_local_combine_fwd", _ARGTYPES)
    err = fn(
        src_pad.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, w, c, v.shape[3], radius,
        int(src_pad.dtype == torch.bfloat16), _cuda.stream_ptr(),
    )
    _cuda.check("local_combine", err)
    _cuda.count_launch("local_combine")
    return out
