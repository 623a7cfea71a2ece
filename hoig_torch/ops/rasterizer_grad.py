"""Exact rasterizer vertex gradients (the neural renderer's backward).

Port of hoig_tpu/ops/rasterizer_grad.py. The reference's CUDA rasterizer
ships three backward kernels (rasterize_cuda_kernel.cu):

  backward_pixel_map (:263-521): edge-walking vertex x / y gradients of the
      silhouette (alpha) and RGB maps. For every face edge and both walk
      axes, the pixels on either side of the edge add
      -(colour difference . upstream gradient) / (distance the edge must
      move to flip that pixel) to the edge's two endpoints.
  backward_textures (:524-559): the RGB gradient scattered into the texels
      through the trilinear weights; here autograd of
      `texture.sample_textures_trilinear` gives it.
  backward_depth_map (:561-611): the perspective depth's derivative through
      the clamped barycentric weights.

The formulation is the JAX package's: the walk is vectorised over (batch,
face, edge, axis) lanes and the whole transverse pixel line, with one loop
over the along-edge coordinate. That is S Python iterations of a few dozen
tensor ops each, so a backward launches thousands of small kernels; JAX has
no Pallas kernel here, and the port writes none. The fully unrolled form
(every along-edge position at once) would hold about 10 GB per image at 512²
with the hand's 1,538 faces.

Everything here works in the UNflipped raster frame (row r is pixel row r);
the autograd Functions at the bottom flip maps and cotangents at the
boundary, as the forward's maps are flipped.
"""

from __future__ import annotations

import torch

from hoig_torch.ops.rasterizer import _face_setup
from hoig_torch.ops.rasterizer_cuda import rasterize_fim_wim_auto
from hoig_torch.ops.table_gather import scatter_rows
from hoig_torch.ops.texture import sample_textures_trilinear

DEFAULT_EPS = 1e-4  # reference rasterize.py:12


def backward_pixel_map(face_verts: torch.Tensor, face_valid: torch.Tensor | None,
                       fim: torch.Tensor, alpha: torch.Tensor | None,
                       grad_alpha: torch.Tensor | None, rgb: torch.Tensor | None,
                       grad_rgb: torch.Tensor | None, image_size: int,
                       eps: float = DEFAULT_EPS) -> torch.Tensor:
    """Edge-walk vertex gradients, batched.

    face_verts (B, F, 3, 3) NDC; fim (B, S, S) int (UNflipped); alpha /
    grad_alpha (B, S, S) or None; rgb / grad_rgb (B, S, S, 3) or None.
    Returns grad_faces (B, F, 3, 3) with a zero z component."""
    s = image_size
    fv = face_verts.float()
    b, f = fv.shape[:2]
    dev = fv.device
    zeros2 = torch.zeros((b, s, s), dtype=torch.float32, device=dev)
    alpha = zeros2 if alpha is None else alpha.float()
    g_alpha = zeros2 if grad_alpha is None else grad_alpha.float()
    use_rgb = rgb is not None
    x, y = fv[..., 0], fv[..., 1]  # (B, F, 3)
    front = (y[..., 2] - y[..., 0]) * (x[..., 1] - x[..., 0]) >= (
        (y[..., 1] - y[..., 0]) * (x[..., 2] - x[..., 0]))
    lane_ok = front if face_valid is None else front & face_valid.bool()

    px = 0.5 * (x * s + s - 1.0)  # pixel coordinates (kernel :297-300)
    py = 0.5 * (y * s + s - 1.0)
    # lanes (B, F, 3 edges, 2 axes); endpoint k of edge e is vertex (e + k) % 3,
    # its (d0, d1) = (x, y) on axis 0 and (y, x) on axis 1 (kernel :306-311)
    e_idx = torch.arange(3, device=dev)

    def coords(shift):
        i = (e_idx + shift) % 3
        cx, cy = px[..., i], py[..., i]  # (B, F, 3)
        return torch.stack([cx, cy], -1), torch.stack([cy, cx], -1)  # d0, d1: (B, F, 3, 2)

    p00, p01 = coords(0)
    p10, p11 = coords(1)
    p20, p21 = coords(2)

    lt = p00 < p10
    sign = torch.tensor([[-1.0, 1.0], [1.0, -1.0]], device=dev)
    direction = torch.where(lt, sign[0], sign[1])  # (B, F, 3, 2)
    d0_from = torch.minimum(p00, p10).ceil().clamp_min(0.0)
    # the C int cast truncates toward zero (matters for off-screen faces only)
    d0_to = torch.maximum(p00, p10).clamp_max(s - 1.0).trunc()
    inf = torch.tensor(torch.inf, device=dev)
    slope = (p11 - p01) / torch.where(p10 == p00, inf, p10 - p00)
    slope02 = (p21 - p01) / torch.where(p20 == p00, inf, p20 - p00)
    slope12 = (p11 - p21) / torch.where(p10 == p20, inf, p10 - p20)
    base = (p10 - p00)[..., None]
    d1_limit_o = torch.where(direction > 0, s - 1.0, 0.0)

    d1v = torch.arange(s, dtype=torch.float32, device=dev)  # transverse coordinate
    face_ids = torch.arange(f, device=dev).view(1, f, 1, 1)
    lane_axis = torch.arange(2, device=dev).view(1, 1, 1, 2)
    acc = torch.zeros((b, f, 3, 2, 2), dtype=torch.float32, device=dev)
    lane_shape = (b, f * 6)

    def pick(line, i):
        # line (B, 2, S[, 3]); i (B, F, 3, 2) -> line[b, axis, i] per lane
        flat = (lane_axis * s + i).reshape(lane_shape)
        if line.dim() == 3:
            return torch.gather(line.reshape(b, 2 * s), 1, flat).reshape(i.shape)
        out = torch.gather(line.reshape(b, 2 * s, 3), 1, flat[..., None].expand(-1, -1, 3))
        return out.reshape(i.shape + (3,))

    def along(line):
        # the whole transverse line of each lane's axis: (B, 1, 1, 2, S[, 3])
        return line[:, None, None]

    for d0i in range(s):
        d0 = float(d0i)
        active = lane_ok[..., None, None] & (d0 >= d0_from) & (d0 <= d0_to)
        d1_cross = slope * (d0 - p00) + p01  # (B, F, 3, 2)
        d1_in = torch.where(direction > 0, d1_cross.floor(), d1_cross.ceil())
        d1_out = d1_in + direction
        inb = (d1_in >= 0) & (d1_in < s) & (d1_out >= 0) & (d1_out < s)
        ok = active & inb & torch.isfinite(d1_cross)

        # transverse lines at d0: axis 0 walks column d0, axis 1 row d0
        line_a = torch.stack([alpha[:, :, d0i], alpha[:, d0i, :]], 1)  # (B, 2, S)
        line_ga = torch.stack([g_alpha[:, :, d0i], g_alpha[:, d0i, :]], 1)
        line_f = torch.stack([fim[:, :, d0i], fim[:, d0i, :]], 1)
        # d1_in is integral, so the cast is exact; lanes whose crossing is not
        # finite are masked by `ok` and read pixel 0
        i_in = d1_in.nan_to_num(0.0).clamp(0, s - 1).long()
        i_out = d1_out.nan_to_num(0.0).clamp(0, s - 1).long()
        a_in, a_out = pick(line_a, i_in), pick(line_a, i_out)
        is_in_fn = ok & (pick(line_f, i_in) == face_ids)

        # OUT side: from d1_out to the border, gated by the in-pixel being this
        # face's (kernel :373-431)
        lo_o = torch.minimum(d1_out, d1_limit_o)[..., None]
        hi_o = torch.maximum(d1_out, d1_limit_o)[..., None]
        in_rng_o = (d1v >= lo_o) & (d1v <= hi_o)
        diff_o = (along(line_a) - a_in[..., None]) * along(line_ga)  # (B, F, 3, 2, S)
        # IN side: from d1_in to the third edge's crossing, per pixel of this
        # face (kernel :434-516)
        straddles = (d0 - p00) * (d0 - p20) < 0
        d0_cross2 = torch.where(straddles, slope02 * (d0 - p00) + p01,
                                slope12 * (d0 - p20) + p21)
        d1_limit_i = torch.where(direction > 0, d0_cross2.ceil(), d0_cross2.floor())
        lo_i = torch.minimum(d1_in, d1_limit_i).clamp_min(0.0)[..., None]
        hi_i = torch.maximum(d1_in, d1_limit_i).clamp_max(s - 1.0)[..., None]
        in_rng_i = (d1v >= lo_i) & (d1v <= hi_i)
        diff_i = (along(line_a) - a_out[..., None]) * along(line_ga)
        if use_rgb:
            line_r = torch.stack([rgb[:, :, d0i], rgb[:, d0i, :]], 1).float()  # (B, 2, S, 3)
            line_gr = torch.stack([grad_rgb[:, :, d0i], grad_rgb[:, d0i, :]], 1).float()
            r_in, r_out = pick(line_r, i_in), pick(line_r, i_out)
            diff_o = diff_o + ((along(line_r) - r_in[..., None, :]) * along(line_gr)).sum(-1)
            diff_i = diff_i + ((along(line_r) - r_out[..., None, :]) * along(line_gr)).sum(-1)
        m_o = is_in_fn[..., None] & in_rng_o & (diff_o > 0)
        pix_is_fn = along(line_f) == face_ids[..., None]
        m_i = (ok[..., None] & pix_is_fn & in_rng_i & (diff_i > 0)
               & torch.isfinite(d0_cross2)[..., None])

        # distances, shared by both walks (kernel :421-430, :503-512)
        rel = d1v - d1_cross[..., None]
        dist0 = base / (p10 - d0)[..., None] * rel * (2.0 / s)
        dist1 = base / (d0 - p00)[..., None] * rel * (2.0 / s)
        dist0 = torch.where(dist0 > 0, dist0 + eps, dist0 - eps)
        dist1 = torch.where(dist1 > 0, dist1 + eps, dist1 - eps)
        ok0 = (p10 != d0)[..., None]
        ok1 = (p00 != d0)[..., None]
        g0 = -(torch.where(m_o & ok0, diff_o / dist0, 0.0)
               + torch.where(m_i & ok0, diff_i / dist0, 0.0)).sum(-1)
        g1 = -(torch.where(m_o & ok1, diff_o / dist1, 0.0)
               + torch.where(m_i & ok1, diff_i / dist1, 0.0)).sum(-1)
        acc += torch.stack([g0, g1], -1)

    # fold lanes onto vertices: lane (edge e, axis a), endpoint 0 -> vertex e,
    # endpoint 1 -> vertex (e + 1) % 3, coordinate 1 - a
    gxy = torch.zeros((b, f, 3, 2), dtype=torch.float32, device=dev)
    nxt = torch.tensor([1, 2, 0], device=dev)
    for a in range(2):
        c = 1 - a
        gxy[..., c] += acc[..., a, 0]
        gxy[:, :, nxt, c] += acc[..., a, 1]
    return torch.cat([gxy, torch.zeros_like(gxy[..., :1])], -1)


def backward_depth_map(face_verts: torch.Tensor, face_valid: torch.Tensor | None,
                       fim: torch.Tensor, depth: torch.Tensor, grad_depth: torch.Tensor,
                       image_size: int) -> torch.Tensor:
    """Analytic depth-map vertex gradients (kernel :561-611), batched. All
    maps UNflipped; the barycentric weights are recomputed as the forward
    computes them. Returns grad_faces (B, F, 3, 3). The per-face sums are
    `scatter_rows` (ascending pixel order, in f32, on both devices)."""
    s = image_size
    b, f = face_verts.shape[:2]
    setup = _face_setup(face_verts, face_valid, s)
    finv, zc = setup["finv"], setup["z"]  # (B, F, 3, 3), (B, F, 3)
    hit = (fim >= 0).reshape(b, -1)
    idx = fim.reshape(b, -1).clamp_min(0).long()  # (B, P)
    finv_w = torch.gather(finv.reshape(b, f, 9), 1, idx[..., None].expand(-1, -1, 9))
    finv_w = finv_w.reshape(b, -1, 3, 3)
    z_w = torch.gather(zc, 1, idx[..., None].expand(-1, -1, 3))  # (B, P, 3)
    ar = torch.arange(s, dtype=torch.float32, device=fim.device)
    yi, xi = torch.meshgrid(ar, ar, indexing="ij")
    xi, yi = xi.reshape(1, -1, 1), yi.reshape(1, -1, 1)
    w = finv_w[..., 0] * xi + finv_w[..., 1] * yi + finv_w[..., 2]
    w = w.clamp(0.0, 1.0)
    w = w / (w[..., 0:1] + w[..., 1:2] + w[..., 2:3]).clamp_min(1e-12)

    dp = depth.reshape(b, -1).float()
    g = torch.where(hit, grad_depth.reshape(b, -1).float(), 0.0)
    d2 = dp * dp
    safe_z = torch.where(z_w.abs() < 1e-12, 1e-12, z_w)
    gz = g[..., None] * w * d2[..., None] / (safe_z * safe_z)  # (B, P, 3)
    q = finv_w / safe_z[..., None]
    tmp = -(q[:, :, 0] + q[:, :, 1] + q[:, :, 2])  # (B, P, 3)
    gxyk = (-g[..., None, None] * tmp[:, :, None, :2] * w[..., None] * d2[..., None, None]
            * (s / 2.0))  # (B, P, 3 vertices, 2)
    contrib = torch.cat([gxyk, gz[..., None]], -1)  # (B, P, 3, 3)
    # background pixels (index -1) add to no face
    out = scatter_rows(contrib.reshape(b, -1, 9), torch.where(hit, idx, -1), f)
    return out.reshape(b, f, 3, 3)


# ---------------------------------------------------------------------------
# autograd Functions: the hard forward maps (B2 + B3 on CUDA tensors) with the
# reference's backward. face_valid travels as a float 1 / 0 mask, as in the
# JAX package's custom VJPs; it gets no gradient.
# ---------------------------------------------------------------------------


def _unflip(m: torch.Tensor) -> torch.Tensor:
    return m.flip(1)


class _SilhouetteExact(torch.autograd.Function):
    @staticmethod
    def forward(ctx, face_verts, valid_f, image_size, near, far, chunk, eps):
        fim, _ = rasterize_fim_wim_auto(face_verts, valid_f > 0.5, image_size=image_size,
                                        near=near, far=far, chunk=chunk)
        sil = (fim >= 0).float()
        ctx.save_for_backward(face_verts, valid_f, _unflip(fim), _unflip(sil))
        ctx.image_size, ctx.eps = image_size, eps
        return sil

    @staticmethod
    def backward(ctx, g):
        face_verts, valid_f, fim_u, sil_u = ctx.saved_tensors
        grad = backward_pixel_map(face_verts, valid_f > 0.5, fim_u, sil_u, _unflip(g),
                                  None, None, ctx.image_size, ctx.eps)
        return grad.to(face_verts.dtype), None, None, None, None, None, None


def rasterize_silhouette_exact(face_verts, valid_f, image_size=256, near=0.1, far=100.0,
                               chunk=128, eps=DEFAULT_EPS):
    """Hard silhouette (B, S, S) whose backward is the reference's
    backward_pixel_map on alpha. valid_f: (B, F) float 1 / 0 mask."""
    return _SilhouetteExact.apply(face_verts, valid_f, image_size, near, far, chunk, eps)


class _DepthExact(torch.autograd.Function):
    @staticmethod
    def forward(ctx, face_verts, valid_f, image_size, near, far, chunk):
        fim, _, dim = rasterize_fim_wim_auto(face_verts, valid_f > 0.5,
                                             image_size=image_size, near=near, far=far,
                                             chunk=chunk, depth=True)
        ctx.save_for_backward(face_verts, valid_f, _unflip(fim), _unflip(dim))
        ctx.image_size = image_size
        return dim

    @staticmethod
    def backward(ctx, g):
        face_verts, valid_f, fim_u, dim_u = ctx.saved_tensors
        grad = backward_depth_map(face_verts, valid_f > 0.5, fim_u, dim_u, _unflip(g),
                                  ctx.image_size)
        return grad.to(face_verts.dtype), None, None, None, None, None


def rasterize_depth_exact(face_verts, valid_f, image_size=256, near=0.1, far=100.0, chunk=128):
    """Depth map (B, S, S) whose backward is the reference's backward_depth_map."""
    return _DepthExact.apply(face_verts, valid_f, image_size, near, far, chunk)


class _RGBExact(torch.autograd.Function):
    @staticmethod
    def forward(ctx, face_verts, textures, valid_f, image_size, near, far, chunk, eps,
                background_color):
        fim, wim = rasterize_fim_wim_auto(face_verts, valid_f > 0.5,
                                          image_size=image_size, near=near, far=far, chunk=chunk)
        rgb = sample_textures_trilinear(textures, fim, wim, background_color)
        ctx.save_for_backward(face_verts, textures, valid_f, fim, wim, rgb)
        ctx.image_size, ctx.eps, ctx.bg = image_size, eps, background_color
        return rgb

    @staticmethod
    def backward(ctx, g):
        face_verts, textures, valid_f, fim, wim, rgb = ctx.saved_tensors
        grad_tex = None
        if ctx.needs_input_grad[1]:
            # autograd of the sampling gather: the reference's backward_textures
            with torch.enable_grad():
                tex = textures.detach().requires_grad_()
                out = sample_textures_trilinear(tex, fim, wim, ctx.bg)
                (grad_tex,) = torch.autograd.grad(out, tex, g)
        grad_faces = backward_pixel_map(face_verts, valid_f > 0.5, _unflip(fim), None,
                                        None, _unflip(rgb), _unflip(g), ctx.image_size, ctx.eps)
        return grad_faces.to(face_verts.dtype), grad_tex, None, None, None, None, None, None, None


def render_rgb_exact(face_verts, textures, valid_f, image_size=256, near=0.1, far=100.0,
                     chunk=128, eps=DEFAULT_EPS, background_color=(0.0, 0.0, 0.0)):
    """RGB render (B, S, S, 3): trilinear texture sampling over the hard
    rasterization, with the reference RasterizeFunction's backward: the
    texture gradient through the sampling weights, the vertex x / y gradient
    from the edge-walking pixel map, and no vertex gradient through the
    barycentric weights (rasterize.py:102-160 saves them as a buffer)."""
    return _RGBExact.apply(face_verts, textures, valid_f, image_size, near, far, chunk, eps,
                           background_color)
