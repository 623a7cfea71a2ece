"""Texture sampling and lighting for the generic RGB render path.

Port of hoig_tpu/ops/texture.py (the neural renderer's texture model):
per-face (T, T, T, 3) texture cubes sampled trilinearly at the barycentric
weights of each pixel's face, and ambient + directional lighting from face
normals. The eight corner reads are one exact row gather from the
flattened cubes, added in the JAX package's order; their gradient with
respect to the textures is `scatter_rows`, whose sums run in a fixed order
on both devices.
"""

from __future__ import annotations

import torch

from hoig_torch.ops.table_gather import gather_rows_nhwc


def lighting(face_verts: torch.Tensor, textures: torch.Tensor, intensity_ambient: float = 0.5,
             intensity_directional: float = 0.5, color_ambient=(1.0, 1.0, 1.0),
             color_directional=(1.0, 1.0, 1.0), direction=(0.0, 1.0, 0.0)) -> torch.Tensor:
    """Scale per-face textures by ambient + directional light.

    face_verts (B, F, 3, 3); textures (B, F, T, T, T, 3)."""
    dt, dev = textures.dtype, textures.device
    v10 = face_verts[:, :, 0] - face_verts[:, :, 1]
    v12 = face_verts[:, :, 2] - face_verts[:, :, 1]
    n = torch.linalg.cross(v12, v10, dim=-1)
    n = n / torch.linalg.norm(n, dim=-1, keepdim=True).clamp_min(1e-8)
    amb = torch.tensor(color_ambient, dtype=dt, device=dev) * intensity_ambient
    dir_color = torch.tensor(color_directional, dtype=dt, device=dev)
    d = torch.tensor(direction, dtype=dt, device=dev)
    d = d / torch.linalg.norm(d).clamp_min(1e-8)
    cos = torch.relu((n * d).sum(-1))
    light = amb + intensity_directional * dir_color * cos[..., None]  # (B, F, 3)
    return textures * light[:, :, None, None, None, :]


def sample_textures_trilinear(textures: torch.Tensor, fim: torch.Tensor, wim: torch.Tensor,
                              background_color=(0, 0, 0)) -> torch.Tensor:
    """Per-pixel colour from per-face texture cubes.

    textures (B, F, T, T, T, 3); fim (B, S, S), -1 background; wim (B, S, S, 3).
    The cube of the pixel's face is read at wim * (T - 1) per axis with
    trilinear weights. Returns (B, S, S, 3)."""
    b, f, t = textures.shape[0], textures.shape[1], textures.shape[2]
    s1, s2 = fim.shape[1], fim.shape[2]
    hit = (fim >= 0).reshape(b, -1, 1)
    face = fim.clamp_min(0).reshape(b, -1).long()
    flat = textures.reshape(b, f * t * t * t, 3)
    pos = wim.clamp(0.0, 1.0) * (t - 1)
    lo = pos.floor().long().clamp(0, t - 1)
    hi = (lo + 1).clamp(0, t - 1)
    frac = pos - lo.to(pos.dtype)
    base = face * (t * t * t)

    fx, fy, fz = frac[..., 0], frac[..., 1], frac[..., 2]
    idxs, weights = [], []
    for ix, wx in ((lo[..., 0], 1 - fx), (hi[..., 0], fx)):
        for iy, wy in ((lo[..., 1], 1 - fy), (hi[..., 1], fy)):
            for iz, wz in ((lo[..., 2], 1 - fz), (hi[..., 2], fz)):
                idxs.append(base + ((ix * t + iy) * t + iz).reshape(b, -1))
                weights.append(wx * wy * wz)
    vals = gather_rows_nhwc(flat, torch.cat(idxs, 1))
    color = None
    for val, w in zip(vals.chunk(8, dim=1), weights):
        c = val * w.reshape(b, -1, 1)
        color = c if color is None else color + c
    bg = torch.tensor(background_color, dtype=textures.dtype, device=textures.device)
    return torch.where(hit, color, bg).reshape(b, s1, s2, 3)
