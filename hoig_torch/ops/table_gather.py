"""Exact row gathers, and the fixed-order transpose of a row gather.

    gather_rows       out[b, :, p] = table[b, idx[b, p], :]
    gather_rows_nhwc  out[b, p, :] = src[b, idx[b, p], :]
    scatter_rows      out[b, n, :] = sum of val[b, e, :] over e ascending with idx[b, e] == n

Every fim-indexed lookup of the conditioning stage reads rows of a table with
at most a few thousand rows: the rasterizer finish's [finv | attrs] rows and
the texture warp's face-corner rows. On CUDA tensors `gather_rows` launches
the hand-written kernel (csrc/table_gather.cu); on CPU tensors it runs the
plain `torch.take_along_dim`.

Every row gather of the port that carries a gradient goes through
`gather_rows_nhwc` (the `GatherRows` Function): the gather engine's
bilinear corners, `grid_sample`, the texture sampler, the block extractor,
the soft rasterizer's winning edges and the faces' vertices. Its forward
is the exact library gather; its backward is `scatter_rows`, whose sums
run in a fixed order (torch.gather's own backward adds with float atomics
on CUDA, in an order that changes from run to run). On CUDA tensors
`scatter_rows` calls hoig_scatter_rows (counter `scatter_rows`), which
builds the order on the card from integers (count, scan, place, sort each
segment) and sums each row in it (csrc/table_gather.cu); on CPU tensors it
runs `scatter_rows_reference`, which adds in the same order.
"""

from __future__ import annotations

import ctypes

import torch

from hoig_torch.ops import _cuda

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, _P, _P, _I, _I, _I, _I, _P]
# val, idx, out, scratch, scratch length, b, e, n, c, bf16, stages, stream
_SCATTER_ARGS = [_P, _P, _P, _P, ctypes.c_longlong, _I, _I, _I, _I, _I, _I, _P]
# hoig_scatter_rows' stages: build the order into the scratch, sum in it
ORDER, SUM = 1, 2
SCAN_TILE = 4096  # table_gather.cu's kScanTile: rows per block of its scan
_INT_MAX = 2**31 - 1


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


def scatter_order(idx: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The summation order of scatter_rows: (perm, starts), int64.

    The entries (b, e) of idx (B, E), flattened to b * E + e, are sorted
    stably by destination row b * n + idx[b, e], so each row's entries stand
    in ascending e; row r's run is perm[starts[r]:starts[r + 1]]. An entry
    whose index lies outside [0, n) sorts past the last row and adds to none.
    Index arithmetic only: a sort and a search, no sum of values."""
    b, e = idx.shape
    dev = idx.device
    i = idx.long()
    rows = torch.arange(b, device=dev)[:, None] * n + i
    keys = torch.where((i >= 0) & (i < n), rows, b * n).reshape(-1)
    sorted_keys, perm = torch.sort(keys, stable=True)
    starts = torch.searchsorted(sorted_keys, torch.arange(b * n + 1, device=dev))
    return perm, starts


def scatter_rows_reference(val: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """scatter_rows, plain: the same order, then a masked loop over segment
    positions, left to right, in f32 from 0 (float64 stays float64),
    rounded once to val's dtype, so that the kernel gives the same bits."""
    b, e, c = val.shape
    perm, starts = scatter_order(idx, n)
    acc_dtype = torch.promote_types(val.dtype, torch.float32)
    flat = val.reshape(b * e, c).to(acc_dtype)
    first, length = starts[:-1], starts[1:] - starts[:-1]
    acc = torch.zeros((b * n, c), dtype=acc_dtype, device=val.device)
    for k in range(int(length.max()) if length.numel() else 0):
        rows = torch.nonzero(length > k).squeeze(1)
        acc[rows] = acc[rows] + flat[perm[first[rows] + k]]
    return acc.to(val.dtype).reshape(b, n, c)


def scatter_scratch_ints(rows: int, entries: int) -> int:
    """The int32 scratch of hoig_scatter_rows (its scratch_ints, which the
    entry point checks): counts and the long rows' count, the tiled scan
    and its tiles' totals, the long rows, the entries' ids."""
    tiles = -(-(rows + 1) // SCAN_TILE)
    return 2 * (rows + 1) + 1 + tiles + rows + entries


def scatter_rows_stages(val: torch.Tensor, idx: torch.Tensor, n: int, out: torch.Tensor,
                        scratch: torch.Tensor | None, stages: int) -> torch.Tensor:
    """One call of hoig_scatter_rows on a contiguous CUDA val (B, E, C),
    writing out (B, n, C): `stages` ORDER builds the order into the scratch,
    SUM sums in the order the scratch holds, both is scatter_rows. Returns
    the scratch (allocated when None). Counts no launch: scatter_rows does,
    and the order and the sum are timed apart through this."""
    b, e, c = val.shape
    if b * e > _INT_MAX or b * n + 2 > _INT_MAX:
        raise ValueError(f"scatter_rows: {b * e} entries into {b * n} rows exceed int32 ids")
    idx = idx.long().contiguous()
    if scratch is None:
        scratch = torch.empty(scatter_scratch_ints(b * n, b * e), dtype=torch.int32,
                              device=val.device)
    fn = _cuda.kernel("table_gather", "hoig_scatter_rows", _SCATTER_ARGS)
    err = fn(val.data_ptr(), idx.data_ptr(), out.data_ptr(), scratch.data_ptr(), scratch.numel(),
             b, e, n, c, int(val.dtype == torch.bfloat16), stages, _cuda.stream_ptr())
    _cuda.check("table_gather", err, "scatter_rows")
    return scratch


def scatter_rows(val: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """(B, E, C) f32 or bf16 entries, (B, E) integer rows -> (B, n, C) in
    val's dtype: out[b, r] = the sum of val[b, e] over the e (ascending)
    with idx[b, e] == r, taken in f32 and rounded once; a row with no entry
    is 0, an entry outside [0, n) adds to no row. The transpose of a row
    gather, in an order that does not change from run to run. On the card
    B * E and B * n + 2 must fit an int32."""
    if val.dim() != 3 or idx.shape != val.shape[:2]:
        raise ValueError(f"idx {tuple(idx.shape)} does not fit val {tuple(val.shape)}")
    if val.device.type == "cpu":
        return scatter_rows_reference(val, idx, n)
    _cuda.require_cuda(val, idx)
    if val.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"scatter_rows takes f32 or bf16 values, got {val.dtype}")
    b, e, c = val.shape
    out = torch.empty((b, n, c), dtype=val.dtype, device=val.device)
    if out.numel() == 0:
        return out
    scatter_rows_stages(val.contiguous(), idx, n, out, None, ORDER | SUM)
    _cuda.count_launch("scatter_rows")
    return out


class GatherRows(torch.autograd.Function):
    """The exact row gather with a fixed-order backward (scatter_rows); the
    indices get no gradient."""

    @staticmethod
    def forward(ctx, src, idx):
        ctx.save_for_backward(idx)
        ctx.rows = src.shape[1]
        return torch.gather(src, 1, idx[..., None].expand(-1, -1, src.shape[2]))

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return scatter_rows(g, idx, ctx.rows), None


def gather_rows_nhwc(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """src (B, N, C), idx (B, P) int64 in [0, N) -> (B, P, C): src[b, idx[b, p]],
    bit-identical to torch.gather; its gradient is scatter_rows."""
    return GatherRows.apply(src, idx)
