"""Bilinear warping and resampling with torch semantics (zeros padding).

The same arithmetic as hoig_tpu/ops/grid_sample.py, which follows
`F.grid_sample`: four clamped corner fetches weighted in the same order, so
the two packages agree to rounding. Grids are (N, Ho, Wo, 2) with
x = grid[..., 0], y = grid[..., 1] in [-1, 1]; align_corners=False maps
-1 / 1 to the outer pixel edges, True to the outer pixel centres.
"""

from __future__ import annotations

import torch


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
    flat = image.reshape(n, h * w, c)
    out = None
    for dy, wy in ((0, 1.0 - ty), (1, ty)):
        yi = y0 + dy
        y_ok = (yi >= 0) & (yi <= h - 1)
        yc = yi.clamp(0, h - 1).long()
        for dx, wx in ((0, 1.0 - tx), (1, tx)):
            xi = x0 + dx
            x_ok = (xi >= 0) & (xi <= w - 1)
            xc = xi.clamp(0, w - 1).long()
            weight = torch.where(y_ok & x_ok, wy * wx, 0.0).reshape(n, -1, 1)
            idx = (yc * w + xc).reshape(n, -1, 1).expand(-1, -1, c)
            contrib = torch.gather(flat, 1, idx) * weight.to(image.dtype)
            out = contrib if out is None else out + contrib
    return out.reshape(n, grid.shape[1], grid.shape[2], c)


def grid_sample(image: torch.Tensor, grid: torch.Tensor, align_corners: bool = False) -> torch.Tensor:
    """image (N, C, H, W), grid (N, Ho, Wo, 2) -> (N, C, Ho, Wo)."""
    out = grid_sample_nhwc(image.permute(0, 2, 3, 1), grid, align_corners)
    return out.permute(0, 3, 1, 2)


# the JAX package packs the 2x2 footprint into one wide-row gather for the
# TPU; the values are those of grid_sample
grid_sample_packed = grid_sample


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
