"""Camera projection for the conditioning stage (port of
hoig_tpu/geometry/projection.py; reference utils/nmr.py:109-140 and the
neural renderer's look_at / vertices_to_faces)."""

from __future__ import annotations

import numpy as np
import torch

# HOGAN views the NDC plane from eye = (0, 0, -(1/tan(30 deg) + 1)) at the
# origin, +y up: the look_at rotation is the identity, so the view transform
# is a pure z shift.
HOGAN_VIEWING_ANGLE = 30.0
HOGAN_EYE_Z = float(1.0 / np.tan(np.radians(HOGAN_VIEWING_ANGLE)) + 1.0)


def orthographic_proj_withz_idrot(pts3d: torch.Tensor, cam: torch.Tensor, offset_z: float = 0.0,
                                  image_size: int = 256) -> torch.Tensor:
    """camMat + crop affine projection (HOv3). pts3d (B, N, 3), cam (B, 15)
    -> (B, N, 3): x, y in [-1, 1] crop NDC, z = -z_cam + offset_z."""
    bs = cam.shape[0]
    cam_mat = cam[:, 0:9].reshape(bs, 3, 3)
    trans = cam[:, 9:15].reshape(bs, 2, 3)
    flipped = pts3d * torch.tensor([1.0, -1.0, -1.0], dtype=pts3d.dtype, device=pts3d.device)
    proj = torch.einsum("bnk,bmk->bnm", flipped, cam_mat)
    xy = proj[:, :, :2] / proj[:, :, 2:3]
    xy1 = torch.cat([xy, torch.ones_like(xy[:, :, :1])], dim=2)
    xy_crop = torch.einsum("bmk,bnk->bnm", trans, xy1)
    xy_ndc = xy_crop / float(image_size - 1) * 2.0 - 1.0
    z = flipped[:, :, 2:3] + offset_z
    return torch.cat([xy_ndc, z], dim=2)


def orthographic_proj_withz_fxfy(pts3d: torch.Tensor, cam: torch.Tensor, offset_z: float = 0.0,
                                 image_size: int = 256) -> torch.Tensor:
    """DexYCB projection: cam (B, 10) = [fx, fy, cx, cy] ++ 2x3 crop affine;
    no OpenGL flip, z is the raw camera depth."""
    bs = cam.shape[0]
    f = cam[:, 0:2]
    c = cam[:, 2:4]
    trans = cam[:, 4:10].reshape(bs, 2, 3)
    z = pts3d[:, :, 2:3]
    xy = pts3d[:, :, :2] / (z + 1e-8) * f[:, None, :] + c[:, None, :]
    xy1 = torch.cat([xy, torch.ones_like(xy[:, :, :1])], dim=2)
    xy_crop = torch.einsum("bmk,bnk->bnm", trans, xy1)
    xy_ndc = xy_crop / float(image_size - 1) * 2.0 - 1.0
    return torch.cat([xy_ndc, z + offset_z], dim=2)


def to_view_space(proj_verts: torch.Tensor) -> torch.Tensor:
    """HOGAN's fixed-camera look_at: y flip, then z shift by the eye distance."""
    flip = torch.tensor([1.0, -1.0, 1.0], dtype=proj_verts.dtype, device=proj_verts.device)
    shift = torch.tensor([0.0, 0.0, HOGAN_EYE_Z], dtype=proj_verts.dtype, device=proj_verts.device)
    return proj_verts * flip + shift


def vertices_to_faces(vertices: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """(B, V, 3) vertices, (F, 3) or (B, F, 3) face ids -> (B, F, 3, 3).
    Negative (padding) ids read vertex 0; callers mask them by face validity."""
    if faces.dim() == 2:
        faces = faces[None].expand(vertices.shape[0], -1, -1)
    b, f, _ = faces.shape
    safe = faces.long().clamp(0, vertices.shape[1] - 1).reshape(b, f * 3, 1)
    gathered = torch.gather(vertices, 1, safe.expand(-1, -1, vertices.shape[2]))
    return gathered.reshape(b, f, 3, 3)
