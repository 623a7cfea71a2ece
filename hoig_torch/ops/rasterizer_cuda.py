"""Tiled z-buffer rasterizer: hand-written CUDA kernels and dispatch.

Counterpart of hoig_tpu/ops/rasterizer_pallas.py. `rasterize_zbuffer`
launches csrc/rasterizer.cu on CUDA tensors (a binning kernel that lists
each 8x8 pixel tile's faces, then the z-buffer over those lists; one call,
counted once as `rasterizer`) and runs the plain chunked reduction
(`rasterizer.zbuffer_reference`) on CPU tensors.
`rasterize_fim_wim_auto` is the conditioning stage's entry: face setup in
PyTorch, the z-buffer, then the winner finish, whose [finv | attrs] row
gather goes through `table_gather.gather_rows` (the B3 kernel on CUDA).
"""

from __future__ import annotations

import ctypes

import torch

from hoig_torch.ops import _cuda
from hoig_torch.ops.rasterizer import _face_setup, finish, zbuffer_reference
from hoig_torch.ops.table_gather import gather_rows

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 7 + [_I] * 5 + [ctypes.c_float, ctypes.c_float, _P]
TILE = 8  # the kernels' tile edge (pixels); the entry point refuses any other
# faces a tile's list holds; a tile that would list more walks every face
# whose box meets it instead (a larger set with the same winners)
LIST_CAP = 1024


def face_bbox(face_verts: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """(B, F, 4) NDC boxes [xmin, xmax, ymin, ymax]; faces not kept get the
    empty box (2, -2, 2, -2), which meets no tile."""
    x = face_verts[..., 0].float()
    y = face_verts[..., 1].float()
    big = 2.0
    return torch.stack(
        [torch.where(keep, x.amin(-1), big), torch.where(keep, x.amax(-1), -big),
         torch.where(keep, y.amin(-1), big), torch.where(keep, y.amax(-1), -big)],
        dim=-1,
    )


def rasterize_zbuffer(setup: dict, bbox: torch.Tensor, image_size: int, near: float,
                      far: float, chunk: int = 128) -> torch.Tensor:
    """Winning face per pixel, (B, S*S) int32, -1 background, raster order.

    setup: `_face_setup` output for (B, F) faces; bbox: `face_bbox`; chunk:
    the face chunk of the plain version (CPU tensors only)."""
    edge, izp, keep = setup["edge"], setup["izp"], setup["keep"]
    if edge.device.type == "cpu":
        return zbuffer_reference(setup, image_size, near, far, chunk)
    b, f = keep.shape
    edge9 = edge.reshape(b, f, 9).contiguous()
    izp = izp.contiguous()
    bbox = bbox.contiguous()
    _cuda.require_cuda(edge9, izp, bbox)
    if not (edge9.dtype == izp.dtype == bbox.dtype == torch.float32):
        raise TypeError("rasterize_zbuffer takes f32 planes and boxes")
    if izp.shape != (b, f, 3) or bbox.shape != (b, f, 4):
        raise ValueError(f"plane/box shapes {tuple(izp.shape)}, {tuple(bbox.shape)} do not fit F={f}")
    dev = edge.device
    idx = torch.empty((b, image_size * image_size), dtype=torch.int32, device=dev)
    # scratch: the packed face records, the tiles' face counts and lists
    tiles = (-(-image_size // TILE)) ** 2
    cap = min(f, LIST_CAP)
    recs = torch.empty((b, f, 16), dtype=torch.float32, device=dev)
    counts = torch.zeros((b, tiles), dtype=torch.int32, device=dev)
    lists = torch.empty((b, tiles, cap), dtype=torch.int32, device=dev)
    # bounds rounded to f32 exactly as the plain version's comparisons are
    iz_lo = float(torch.tensor(1.0 / far, dtype=torch.float32))
    iz_hi = float(torch.tensor(1.0 / near, dtype=torch.float32))
    fn = _cuda.kernel("rasterizer", "hoig_rasterize_zbuffer", _ARGTYPES)
    err = fn(edge9.data_ptr(), izp.data_ptr(), bbox.data_ptr(), recs.data_ptr(),
             counts.data_ptr(), lists.data_ptr(), idx.data_ptr(), b, f, image_size, TILE, cap,
             iz_lo, iz_hi, _cuda.stream_ptr())
    _cuda.check("rasterizer", err)
    _cuda.count_launch("rasterizer")
    return idx


def rasterize_fim_wim_auto(face_verts: torch.Tensor, face_valid: torch.Tensor | None = None,
                           image_size: int = 256, near: float = 0.1, far: float = 100.0,
                           attrs: torch.Tensor | None = None, chunk: int = 128,
                           depth: bool = False):
    """fim (B,S,S) int32, wim (B,S,S,3) f32[, rows (B,S,S,A) with attrs][,
    depth (B,S,S) f32 with depth].

    attrs: optional (B, F+1, A) per-face rows, row F = background; their
    per-pixel rows ride the finish's gather, and so do the winner's corner
    depths with `depth` (`far` on the background). chunk: the plain
    z-buffer's face chunk on CPU tensors."""
    setup = _face_setup(face_verts, face_valid, image_size)
    bbox = face_bbox(face_verts, setup["keep"])
    idx = rasterize_zbuffer(setup, bbox, image_size, near, far, chunk)
    return finish(idx, setup["finv"], attrs, image_size, gather=gather_rows,
                  z=setup["z"] if depth else None, far=far)
