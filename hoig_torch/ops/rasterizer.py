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

from hoig_torch.ops.table_gather import gather_rows_nhwc, gather_rows_reference

_BIG = 1e10


def _face_setup(face_verts: torch.Tensor, face_valid: torch.Tensor | None, image_size: int) -> dict:
    """Per-face plane precomputation, batched over leading axes.

    face_verts (..., F, 3, 3) -> dict with
      edge (..., F, 3, 3): edge-line coefficients, inside iff edge @ (xp, yp, 1) >= 0,
      izp (..., F, 3): inverse-depth plane in integer pixel coordinates,
      finv (..., F, 3, 3): inverse barycentric matrix (pixel coordinates),
      z (..., F, 3): the corners' view depths,
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
    return dict(edge=edges, izp=izp, finv=finv, z=z, keep=keep)


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
           gather=gather_rows_reference, z: torch.Tensor | None = None, far: float = 100.0):
    """Winner finish: gather each pixel's [finv | attrs | z] row, evaluate and
    renormalise its barycentric weights, flip vertically.

    idx: (B, S*S) int32 winners (-1 background), raster order.
    attrs: optional (B, F+1, A) per-face rows, row F = background.
    gather: the row gather, `table_gather.gather_rows` (kernel on CUDA) or
      the plain `gather_rows_reference`.
    z: optional (B, F, 3) corner depths; with them the finish also gives the
      winner's perspective-correct depth, 1 / sum_k(w_k / z_k) from the
      clamped, renormalised weights, `far` on the background.
    Returns fim (B,S,S) int32, wim (B,S,S,3) f32[, rows (B,S,S,A)][, depth
    (B,S,S) f32].
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
    if z is not None:
        table = torch.cat([table, z.float()], dim=2)
        bg_row = torch.cat([bg_row, torch.ones((b, 1, 3), dtype=table.dtype,
                                               device=table.device)], dim=2)
    table = torch.cat([table, bg_row], dim=1).contiguous()  # (B, F+1, 9+A[+3])
    safe = torch.where(hit, idx, f).to(torch.int32)
    fw = gather(table, safe)  # (B, 9+A[+3], S*S)

    w = fw[:, 0:9:3] * xi + fw[:, 1:9:3] * yi + fw[:, 2:9:3]  # (B, 3, S*S)
    w = w.clamp(0.0, 1.0)
    w = w / (w[:, 0:1] + w[:, 1:2] + w[:, 2:3]).clamp_min(1e-12)
    fim = torch.where(hit, idx, -1).reshape(b, s, s).flip(1)
    wim = torch.where(hit[:, None], w, 0.0).transpose(1, 2).reshape(b, s, s, 3).flip(1)
    out = (fim, wim)
    n_attr = 0 if attrs is None else attrs.shape[2]
    if attrs is not None:
        out += (fw[:, 9:9 + n_attr].transpose(1, 2).reshape(b, s, s, -1).flip(1),)
    if z is not None:
        zw = fw[:, 9 + n_attr:]
        zw = torch.where(zw.abs() < 1e-12, 1e-12, zw)
        inv = w[:, 0] / zw[:, 0] + w[:, 1] / zw[:, 1] + w[:, 2] / zw[:, 2]
        depth = torch.where(hit, 1.0 / inv.clamp_min(1e-12), far)
        out += (depth.reshape(b, s, s).flip(1),)
    return out


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


def _hard_maps(face_verts, face_valid, image_size, near, far, chunk, depth):
    # B2 + B3 on CUDA tensors, the plain z-buffer and gather on CPU ones
    from hoig_torch.ops.rasterizer_cuda import rasterize_fim_wim_auto

    return rasterize_fim_wim_auto(face_verts, face_valid, image_size=image_size, near=near,
                                  far=far, chunk=chunk, depth=depth)


def rasterize_depth(face_verts: torch.Tensor, face_valid: torch.Tensor | None = None,
                    image_size: int = 256, near: float = 0.1, far: float = 100.0,
                    chunk: int = 128) -> torch.Tensor:
    """(B, S, S) view depth of the winning face, `far` on the background
    (the neural renderer's rasterize_depth). On CUDA the winner comes from the
    B2 kernel and its row from B3; `chunk` sizes the plain z-buffer on CPU."""
    return _hard_maps(face_verts, face_valid, image_size, near, far, chunk, True)[2]


def rasterize_silhouette(face_verts: torch.Tensor, face_valid: torch.Tensor | None = None,
                         image_size: int = 256, near: float = 0.1, far: float = 100.0,
                         chunk: int = 128) -> torch.Tensor:
    """(B, S, S) f32 coverage mask, 1 where a face wins (rasterize_silhouettes)."""
    fim = _hard_maps(face_verts, face_valid, image_size, near, far, chunk, False)[0]
    return (fim >= 0).float()


def soft_silhouette(face_verts: torch.Tensor, face_valid: torch.Tensor | None = None,
                    image_size: int = 256, sigma: float = 1.0, chunk: int = 128) -> torch.Tensor:
    """Differentiable coverage: per pixel, sigmoid(S / (2 sigma) * m), m the
    largest over kept faces of the face's smallest normalised edge function
    (a signed distance, positive inside). (B, S, S) in (0, 1), flipped
    vertically like the hard maps.

    The JAX package forms the whole (pixels, faces, 3) tensor and lets
    autodiff take the max and min apart. Here the faces go by in chunks of
    `chunk` without gradient, keeping the running maximum and its (face,
    edge); the maximum over faces is exact, so the value is the same. The
    winner's edge function is then evaluated again with gradient, so the
    vertex gradient is the JAX package's wherever the max and min are
    unique (on ties JAX shares the gradient between the tied entries). Peak
    memory is a few (pixels, chunk, 3) tensors instead of (pixels, faces, 3).
    A face with a zero-length edge gets a zero gradient through that edge's
    norm, where the JAX package's is NaN."""
    s = image_size
    b, f = face_verts.shape[:2]
    dev = face_verts.device
    _, _, xp, yp = _pixel_grids(s, dev)
    scale = s / (2.0 * sigma)
    setup = _face_setup(face_verts, face_valid, s)
    e, keep = setup["edge"], setup["keep"]  # (B, F, 3, 3), (B, F)
    # sqrt(max(x, 1e-16)) is the JAX package's max(sqrt(x), 1e-8), with a zero
    # gradient below the floor: at a zero-length edge (a face that repeats a
    # vertex) sqrt's own gradient is 0 / 0, and JAX's vertex gradient NaN
    norm = torch.sqrt((e[..., 0] ** 2 + e[..., 1] ** 2).clamp_min(1e-16))  # (B, F, 3)
    n_pix = s * s
    with torch.no_grad():
        best = torch.full((b, n_pix), -torch.inf, device=dev)
        arg = torch.zeros((b, n_pix), dtype=torch.long, device=dev)
        for base in range(0, f, chunk):
            ec, nc = e[:, base:base + chunk], norm[:, base:base + chunk]
            d = (xp[None, :, None, None] * ec[:, None, :, :, 0]
                 + yp[None, :, None, None] * ec[:, None, :, :, 1]
                 + ec[:, None, :, :, 2]) / nc[:, None]  # (B, P, c, 3)
            inside, edge_arg = d.min(dim=-1)  # (B, P, c)
            inside = torch.where(keep[:, None, base:base + chunk], inside, -1e6)
            cmax, cface = inside.max(dim=-1)  # first of equal values: the lowest face
            cedge = torch.gather(edge_arg, 2, cface[..., None])[..., 0]
            better = cmax > best
            best = torch.where(better, cmax, best)
            arg = torch.where(better, (base + cface) * 3 + cedge, arg)
    face = arg // 3
    # (B, P, 4) with gradient, which adds in a fixed order
    rows = gather_rows_nhwc(torch.cat([e, norm[..., None]], dim=-1).reshape(b, f * 3, 4), arg)
    m = (xp * rows[..., 0] + yp * rows[..., 1] + rows[..., 2]) / rows[..., 3]
    m = torch.where(torch.gather(keep, 1, face), m, -1e6)
    return torch.sigmoid(scale * m).reshape(b, s, s).flip(1)
