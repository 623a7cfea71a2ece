"""Bilinear warping and resampling with torch semantics (zeros padding).

The same arithmetic as hoig_tpu/ops/grid_sample.py, which follows
`F.grid_sample`: four clamped corner fetches weighted in the same order, so
the two packages agree to rounding. Grids are (N, Ho, Wo, 2) with
x = grid[..., 0], y = grid[..., 1] in [-1, 1]; align_corners=False maps
-1 / 1 to the outer pixel edges, True to the outer pixel centres.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from hoig_torch.ops.table_gather import gather_rows_nhwc


def _unnormalize(coord: torch.Tensor, size: int, align_corners: bool) -> torch.Tensor:
    if align_corners:
        return (coord + 1.0) * 0.5 * (size - 1)
    return ((coord + 1.0) * size - 1.0) * 0.5


def grid_sample_nhwc(image: torch.Tensor, grid: torch.Tensor, align_corners: bool = False) -> torch.Tensor:
    """image (N, H, W, C), grid (N, Ho, Wo, 2) -> (N, Ho, Wo, C)."""
    n, h, w, c = image.shape
    gx = _unnormalize(grid[..., 0].float(), w, align_corners)
    gy = _unnormalize(grid[..., 1].float(), h, align_corners)
    x0, y0 = gx.floor(), gy.floor()
    tx, ty = gx - x0, gy - y0
    weights, idxs = [], []
    for dy, wy in ((0, 1.0 - ty), (1, ty)):
        yi = y0 + dy
        y_ok = (yi >= 0) & (yi <= h - 1)
        yc = yi.clamp(0, h - 1).long()
        for dx, wx in ((0, 1.0 - tx), (1, tx)):
            xi = x0 + dx
            x_ok = (xi >= 0) & (xi <= w - 1)
            xc = xi.clamp(0, w - 1).long()
            weights.append(torch.where(y_ok & x_ok, wy * wx, 0.0).reshape(n, -1, 1))
            idxs.append((yc * w + xc).reshape(n, -1))
    # the four corners in one row gather (fixed-order backward: scatter_rows)
    vals = gather_rows_nhwc(image.reshape(n, h * w, c), torch.cat(idxs, 1))
    out = None
    for val, weight in zip(vals.chunk(4, dim=1), weights):
        contrib = val * weight.to(image.dtype)
        out = contrib if out is None else out + contrib
    return out.reshape(n, grid.shape[1], grid.shape[2], c)


def grid_sample(image: torch.Tensor, grid: torch.Tensor, align_corners: bool = False) -> torch.Tensor:
    """image (N, C, H, W), grid (N, Ho, Wo, 2) -> (N, C, Ho, Wo)."""
    out = grid_sample_nhwc(image.permute(0, 2, 3, 1), grid, align_corners)
    return out.permute(0, 3, 1, 2)


def grid_sample_packed(image: torch.Tensor, grid: torch.Tensor,
                       align_corners: bool = False) -> torch.Tensor:
    """`grid_sample` under the JAX package's name for its TPU form, which packs
    the 2x2 footprint into one wide-row gather (narrow row gathers are slow on
    the TPU). The values are those of `grid_sample`; so is the arithmetic here.
    image (N, C, H, W), grid (N, Ho, Wo, 2) -> (N, C, Ho, Wo)."""
    return grid_sample(image, grid, align_corners)


def _resize_axis_linear_ac(x: torch.Tensor, axis: int, out_size: int) -> torch.Tensor:
    """1-D linear resize along `axis` with align_corners=True, evaluated as
    the JAX package does (so a resized flow floors to the same shifts)."""
    in_size = x.shape[axis]
    if in_size == out_size:
        return x
    if in_size == 1:
        reps = [1] * x.dim()
        reps[axis] = out_size
        return x.repeat(*reps)
    pos = torch.arange(out_size, dtype=torch.float32, device=x.device) * (
        (in_size - 1) / (out_size - 1)
    )
    i0 = pos.floor().to(torch.int64).clamp(0, in_size - 2)
    t = pos - i0.to(torch.float32)
    a = x.index_select(axis, i0)
    b = x.index_select(axis, i0 + 1)
    shape = [1] * x.dim()
    shape[axis] = out_size
    t = t.reshape(shape).to(x.dtype)
    return a * (1 - t) + b * t


def resize_bilinear_align_corners(image: torch.Tensor, out_hw: tuple) -> torch.Tensor:
    """torch `F.interpolate(mode='bilinear', align_corners=True)` on (..., H, W),
    evaluated axis by axis as the JAX package does."""
    out = _resize_axis_linear_ac(image, image.dim() - 2, out_hw[0])
    return _resize_axis_linear_ac(out, image.dim() - 1, out_hw[1])


def resize_nearest(image: torch.Tensor, out_hw: tuple) -> torch.Tensor:
    """torch `F.interpolate(mode='nearest')` on (..., H, W): source index
    floor(i * in / out), clamped."""
    h, w = image.shape[-2], image.shape[-1]
    dev = image.device
    rows = (torch.arange(out_hw[0], device=dev) * (h / out_hw[0])).floor().long().clamp(0, h - 1)
    cols = (torch.arange(out_hw[1], device=dev) * (w / out_hw[1])).floor().long().clamp(0, w - 1)
    return image.index_select(image.dim() - 2, rows).index_select(image.dim() - 1, cols)


def avg_pool(image: torch.Tensor, ks: int, stride: int | None = None) -> torch.Tensor:
    """torch `F.avg_pool2d` (no padding) over the last two axes of a tensor
    with any number of leading axes."""
    stride = stride or ks
    lead = image.shape[:-2]
    x = image.reshape((-1, 1) + tuple(image.shape[-2:]))
    out = F.avg_pool2d(x, ks, stride)
    return out.reshape(tuple(lead) + tuple(out.shape[-2:]))
