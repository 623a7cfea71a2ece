"""Flow-guided local attention primitives (port of hoig_tpu/ops/block_extractor.py).

The reference's two CUDA extensions behind its `ExtractorAttn`:

  * `block_extractor` (block_extractor_kernel.cu): for every pixel of the
    k x k expanded grid, offset the block's flow vector by the in-block
    position and sample the source bilinearly. Out-of-range corners read
    the border (the kernel clamps the four corner indices but keeps the
    unclamped fractional weights). Kept quirk: the flow is taken in pixel
    units and added to the block index (kernel lines 58-68), although the
    caller hands it a normalised-coordinate difference.
  * `local_attn_reshape`: the k² channels of each location laid out as a
    k x k spatial block; a reshape and a transpose.

Both are dense gathers and views, so autograd gives the reference's
backward: `floor` has a zero gradient, so d(bilinear)/d(flow) is the
kernel's (:163-168), and the source gradient is the gathers' scatter-add.
The reference adds it with atomicAdd, in no fixed order; here the four
corners are one row gather whose backward (`scatter_rows`) adds in a fixed
order, as the JAX package's does on the TPU, and the flow is repeated over
each block by a broadcast, whose backward is a plain sum.
"""

from __future__ import annotations

import torch

from hoig_torch.ops.table_gather import gather_rows_nhwc


def _offsets(h: int, w: int, k: int, device):
    """Per expanded pixel: in-block offset + block index, (k h, k w) each."""
    yy = torch.arange(h * k, device=device)[:, None]
    xx = torch.arange(w * k, device=device)[None, :]
    oy = yy % k - k // 2 + yy // k
    ox = xx % k - k // 2 + xx // k
    return ox, oy


def _sample(src_flat: torch.Tensor, dx: torch.Tensor, dy: torch.Tensor, h: int, w: int,
            channel_last: bool) -> torch.Tensor:
    """Bilinear read of src_flat ((B, C, HW) or (B, HW, C)) at (dx, dy)
    (B, kh, kw) with clamped corners and unclamped weights."""
    b = dx.shape[0]
    x0, y0 = dx.floor(), dy.floor()
    tx, ty = dx - x0, dy - y0
    idxs, wgts = [], []
    for dyi, wy in ((0, 1.0 - ty), (1, ty)):
        ycl = (y0 + dyi).clamp(0, h - 1).long()
        for dxi, wx in ((0, 1.0 - tx), (1, tx)):
            xcl = (x0 + dxi).clamp(0, w - 1).long()
            idxs.append((ycl * w + xcl).reshape(b, -1))
            wgts.append((wy * wx).reshape(b, -1).to(src_flat.dtype))
    # the four corners in one row gather of the (B, HW, C) rows
    rows = src_flat if channel_last else src_flat.transpose(1, 2)
    vals = gather_rows_nhwc(rows, torch.cat(idxs, 1)).chunk(4, dim=1)
    out = None
    for val, wgt in zip(vals, wgts):
        if channel_last:
            contrib = val * wgt[..., None]
        else:
            contrib = val.transpose(1, 2) * wgt[:, None]
        out = contrib if out is None else out + contrib
    return out


def block_extractor(source: torch.Tensor, flow: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """source (B, C, H, W); flow (B, 2, H, W), channel 0 = x, 1 = y offset in
    pixel units -> (B, C, k H, k W)."""
    b, c, h, w = source.shape
    k = kernel_size
    ox, oy = _offsets(h, w, k, source.device)
    flow_up = flow[:, :, :, None, :, None].expand(b, 2, h, k, w, k).reshape(b, 2, h * k, w * k)
    dx = flow_up[:, 0] + ox.to(flow.dtype)
    dy = flow_up[:, 1] + oy.to(flow.dtype)
    out = _sample(source.reshape(b, c, h * w), dx, dy, h, w, channel_last=False)
    return out.reshape(b, c, h * k, w * k)


def local_attn_reshape(x: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """(B, k*k, H, W), channel = oy * k + ox -> (B, 1, k H, k W)."""
    b, kk, h, w = x.shape
    k = kernel_size
    if kk != k * k:
        raise ValueError(f"channel dim {kk} != kernel_size^2 {k * k}")
    return x.reshape(b, k, k, h, w).permute(0, 3, 1, 4, 2).reshape(b, 1, h * k, w * k)


def block_extractor_nhwc(source: torch.Tensor, flow: torch.Tensor,
                         kernel_size: int) -> torch.Tensor:
    """source (B, H, W, C); flow (B, H, W, 2), [..., 0] = x, [..., 1] = y in
    pixel units -> (B, k H, k W, C)."""
    b, h, w, c = source.shape
    k = kernel_size
    ox, oy = _offsets(h, w, k, source.device)
    flow_up = flow[:, :, None, :, None].expand(b, h, k, w, k, 2).reshape(b, h * k, w * k, 2)
    dx = flow_up[..., 0] + ox.to(flow.dtype)
    dy = flow_up[..., 1] + oy.to(flow.dtype)
    out = _sample(source.reshape(b, h * w, c), dx, dy, h, w, channel_last=True)
    return out.reshape(b, h * k, w * k, c)


def local_attn_reshape_nhwc(x: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """(B, H, W, k*k) -> (B, k H, k W, 1)."""
    b, h, w, kk = x.shape
    k = kernel_size
    if kk != k * k:
        raise ValueError(f"channel dim {kk} != kernel_size^2 {k * k}")
    return x.reshape(b, h, w, k, k).permute(0, 1, 3, 2, 4).reshape(b, h * k, w * k, 1)
