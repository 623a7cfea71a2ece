"""Exact row gather from small per-sample tables, channel-first.

    out[b, :, p] = table[b, idx[b, p], :]

Every fim-indexed lookup of the conditioning stage reads rows of a table with
at most a few thousand rows: the rasterizer finish's [finv | attrs] rows and
the texture warp's face-corner rows. On CUDA tensors `gather_rows` launches
the hand-written kernel (csrc/table_gather.cu); on CPU tensors it runs the
plain `torch.take_along_dim`.
"""

from __future__ import annotations

import ctypes

import torch

from hoig_torch.ops import _cuda

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, _P, _P, _I, _I, _I, _I, _P]


def gather_rows_reference(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    rows = torch.take_along_dim(table, idx.long()[..., None], dim=1)
    return rows.transpose(1, 2)


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, R, A) f32 table, (B, P) int32 indices in [0, R) -> (B, A, P) f32.

    Bit-identical to take_along_dim, laid out channel-first."""
    b, r, a = table.shape
    if idx.dim() != 2 or idx.shape[0] != b:
        raise ValueError(f"idx {tuple(idx.shape)} does not fit table {tuple(table.shape)}")
    if table.device.type == "cpu":
        return gather_rows_reference(table, idx)
    _cuda.require_cuda(table, idx)
    if table.dtype != torch.float32 or idx.dtype != torch.int32:
        raise TypeError(f"gather_rows takes an f32 table and int32 indices, got {table.dtype}, {idx.dtype}")
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("gather_rows needs contiguous inputs")
    p = idx.shape[1]
    out = torch.empty((b, a, p), dtype=torch.float32, device=table.device)
    fn = _cuda.kernel("table_gather", "hoig_gather_rows", _ARGTYPES)
    err = fn(table.data_ptr(), idx.data_ptr(), out.data_ptr(), b, r, a, p, _cuda.stream_ptr())
    _cuda.check("table_gather", err)
    _cuda.count_launch("table_gather")
    return out
