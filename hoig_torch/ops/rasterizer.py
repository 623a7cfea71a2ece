"""Z-buffer rasterization into face-index (fim) and barycentric (wim) maps.

Same contract as hoig_tpu/ops/rasterizer.py, which follows the reference's
neural_renderer CUDA rasterizer:

  * faces are (B, F, 3 vertices, 3 xyz), x, y in [-1, 1] NDC, z the positive
    view-space depth; back faces are culled by the 2-D signed-area test,
  * a pixel (xi, yi) with centre ((2 xi + 1 - S) / S, (2 yi + 1 - S) / S) hits
    a face iff it is on the in-side of all three edge lines,
  * the nearest face wins by the largest inverse-depth plane value in
    (1/far, 1/near); ties go to the lowest face index; background is -1,
  * barycentric weights of the winner are evaluated at integer pixel
    coordinates, clamped to [0, 1] and renormalised,
  * the maps are flipped vertically.

`rasterize_fim_wim` here is the plain PyTorch version (a chunked dense
reduction over faces). The hand-written kernel and the dispatch live in
ops/rasterizer_cuda.py; both share `_face_setup` and `finish`.
"""

from __future__ import annotations

import torch

from hoig_torch.ops.table_gather import gather_rows_reference

_BIG = 1e10


def _face_setup(face_verts: torch.Tensor, face_valid: torch.Tensor | None, image_size: int) -> dict:
    """Per-face plane precomputation, batched over leading axes.

    face_verts (..., F, 3, 3) -> dict with
      edge (..., F, 3, 3): edge-line coefficients, inside iff edge @ (xp, yp, 1) >= 0,
      izp (..., F, 3): inverse-depth plane in integer pixel coordinates,
      finv (..., F, 3, 3): inverse barycentric matrix (pixel coordinates),
      keep (..., F): valid and front-facing.
    """
    fv = face_verts.float()
    x, y, z = fv[..., 0], fv[..., 1], fv[..., 2]  # (..., F, 3)

    front = (y[..., 2] - y[..., 0]) * (x[..., 1] - x[..., 0]) >= (y[..., 1] - y[..., 0]) * (
        x[..., 2] - x[..., 0]
    )
    keep = front if face_valid is None else front & face_valid

    def edge(a, b):
        return torch.stack(
            [-(y[..., b] - y[..., a]), x[..., b] - x[..., a],
             x[..., a] * y[..., b] - y[..., a] * x[..., b]],
            dim=-1,
        )

    edges = torch.stack([edge(0, 1), edge(1, 2), edge(2, 0)], dim=-2)

    s = float(image_size)
    px = 0.5 * (x * s + s - 1.0)
    py = 0.5 * (y * s + s - 1.0)
    denom = (
        px[..., 2] * (py[..., 0] - py[..., 1])
        + px[..., 0] * (py[..., 1] - py[..., 2])
        + px[..., 1] * (py[..., 2] - py[..., 0])
    )
    denom = torch.where(denom.abs() < 1e-12, 1e-12, denom)

    def row(a, b):
        return torch.stack(
            [py[..., a] - py[..., b], px[..., b] - px[..., a],
             px[..., a] * py[..., b] - px[..., b] * py[..., a]],
            dim=-1,
        )

    finv = torch.stack([row(1, 2), row(2, 0), row(0, 1)], dim=-2) / denom[..., None, None]

    inv_z = 1.0 / torch.where(z.abs() < 1e-12, 1e-12, z)
    izp = (finv[..., 0, :] * inv_z[..., 0:1] + finv[..., 1, :] * inv_z[..., 1:2]
           + finv[..., 2, :] * inv_z[..., 2:3])
    return dict(edge=edges, izp=izp, finv=finv, keep=keep)


def _pixel_grids(image_size: int, device) -> tuple:
    """Integer and pixel-centre NDC coordinates, flattened in raster order."""
    s = image_size
    ar = torch.arange(s, dtype=torch.float32, device=device)
    yi, xi = torch.meshgrid(ar, ar, indexing="ij")
    xp = (2.0 * xi + 1.0 - s) / s
    yp = (2.0 * yi + 1.0 - s) / s
    return xi.reshape(-1), yi.reshape(-1), xp.reshape(-1), yp.reshape(-1)


def zbuffer_reference(setup: dict, image_size: int, near: float, far: float,
                      chunk: int = 128) -> torch.Tensor:
    """Plain z-buffer: winning face per pixel, (B, S*S) int32, -1 background,
    in raster order (not flipped). A running (inverse depth, index) reduction
    over face chunks; strict '>' across chunks keeps the lowest index."""
    edge, izp, keep = setup["edge"], setup["izp"], setup["keep"]
    b, f = keep.shape
    dev = edge.device
    xi, yi, xp, yp = _pixel_grids(image_size, dev)
    n_pix = image_size * image_size
    iz_lo = torch.tensor(1.0 / far, dtype=torch.float32, device=dev)
    iz_hi = torch.tensor(1.0 / near, dtype=torch.float32, device=dev)
    out = []
    for bi in range(b):
        best_iz = torch.full((n_pix,), -_BIG, dtype=torch.float32, device=dev)
        best_idx = torch.full((n_pix,), -1, dtype=torch.int32, device=dev)
        for base in range(0, f, chunk):
            e = edge[bi, base : base + chunk]  # (c, 3, 3)
            zc = izp[bi, base : base + chunk]  # (c, 3)
            inside = (
                (xp[:, None, None] * e[None, :, :, 0] + yp[:, None, None] * e[None, :, :, 1]
                 + e[None, :, :, 2]) >= 0
            ).all(dim=-1)
            iz = xi[:, None] * zc[None, :, 0] + yi[:, None] * zc[None, :, 1] + zc[None, :, 2]
            ok = inside & keep[bi, base : base + chunk][None] & (iz > iz_lo) & (iz < iz_hi)
            iz = torch.where(ok, iz, -_BIG)
            chunk_best = iz.amax(dim=1)
            ids = torch.arange(base, base + e.shape[0], dtype=torch.int32, device=dev)
            cand = torch.where(iz >= chunk_best[:, None], ids[None], 2**30)
            chunk_arg = cand.amin(dim=1)
            better = chunk_best > best_iz
            best_iz = torch.where(better, chunk_best, best_iz)
            best_idx = torch.where(better & (chunk_best > -_BIG), chunk_arg, best_idx)
        out.append(best_idx)
    return torch.stack(out)


def finish(idx: torch.Tensor, finv: torch.Tensor, attrs: torch.Tensor | None, image_size: int,
           gather=gather_rows_reference):
    """Winner finish: gather each pixel's [finv | attrs] row, evaluate and
    renormalise its barycentric weights, flip vertically.

    idx: (B, S*S) int32 winners (-1 background), raster order.
    attrs: optional (B, F+1, A) per-face rows, row F = background.
    gather: the row gather, `table_gather.gather_rows` (kernel on CUDA) or
      the plain `gather_rows_reference`.
    Returns fim (B,S,S) int32, wim (B,S,S,3) f32[, rows (B,S,S,A)].
    """
    b, f = finv.shape[:2]
    s = image_size
    xi, yi, _, _ = _pixel_grids(s, idx.device)
    hit = idx >= 0
    table = finv.reshape(b, f, 9)
    bg_row = torch.zeros((b, 1, 9), dtype=table.dtype, device=table.device)
    if attrs is not None:
        table = torch.cat([table, attrs[:, :-1]], dim=2)
        bg_row = torch.cat([bg_row, attrs[:, -1:]], dim=2)
    table = torch.cat([table, bg_row], dim=1).contiguous()  # (B, F+1, 9+A)
    safe = torch.where(hit, idx, f).to(torch.int32)
    fw = gather(table, safe)  # (B, 9+A, S*S)

    w = fw[:, 0:9:3] * xi + fw[:, 1:9:3] * yi + fw[:, 2:9:3]  # (B, 3, S*S)
    w = w.clamp(0.0, 1.0)
    w = w / (w[:, 0:1] + w[:, 1:2] + w[:, 2:3]).clamp_min(1e-12)
    fim = torch.where(hit, idx, -1).reshape(b, s, s).flip(1)
    wim = torch.where(hit[:, None], w, 0.0).transpose(1, 2).reshape(b, s, s, 3).flip(1)
    if attrs is None:
        return fim, wim
    rows = fw[:, 9:].transpose(1, 2).reshape(b, s, s, -1).flip(1)
    return fim, wim, rows


def rasterize_fim_wim(face_verts: torch.Tensor, face_valid: torch.Tensor | None = None,
                      image_size: int = 256, near: float = 0.1, far: float = 100.0,
                      attrs: torch.Tensor | None = None, chunk: int = 128):
    """Plain fim/wim rasterization on any device (no kernel).

    face_verts (B, F, 3, 3); face_valid optional (B, F) bool; attrs optional
    (B, F+1, A). Returns fim (B,S,S) int32, wim (B,S,S,3) f32 and, with attrs,
    rows (B,S,S,A)."""
    setup = _face_setup(face_verts, face_valid, image_size)
    idx = zbuffer_reference(setup, image_size, near, far, chunk)
    return finish(idx, setup["finv"], attrs, image_size)
