"""Camera projection (port of hoig_tpu/geometry/projection.py; reference
utils/nmr.py:109-140, the neural renderer's look_at / vertices_to_faces and
hmr.py's proj_func). The products are full f32 (TF32 is off by default for
torch's CUDA matrix products), as the JAX package asks for HIGHEST."""

from __future__ import annotations

import numpy as np
import torch

from hoig_torch.ops.table_gather import gather_rows_nhwc

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


def look_at(vertices: torch.Tensor, eye, at=(0.0, 0.0, 0.0), up=(0.0, 1.0, 0.0)) -> torch.Tensor:
    """The neural renderer's general look_at (look_at.py:6-62): (B, N, 3)
    world vertices -> view space, the eye at the origin looking along +z."""
    kw = dict(dtype=vertices.dtype, device=vertices.device)
    eye, at, up = torch.tensor(eye, **kw), torch.tensor(at, **kw), torch.tensor(up, **kw)

    def norm(v):
        return v / torch.linalg.norm(v).clamp_min(1e-5)

    z_axis = norm(at - eye)
    x_axis = norm(torch.linalg.cross(up, z_axis))
    y_axis = norm(torch.linalg.cross(z_axis, x_axis))
    r = torch.stack([x_axis, y_axis, z_axis], dim=0)  # (3, 3)
    # the three products summed element-wise, not by a matrix product, so
    # the CPU and the card round them alike
    d = vertices - eye
    return d[..., 0:1] * r[:, 0] + d[..., 1:2] * r[:, 1] + d[..., 2:3] * r[:, 2]


def to_view_space(proj_verts: torch.Tensor) -> torch.Tensor:
    """HOGAN's fixed-camera look_at: y flip, then z shift by the eye distance."""
    flip = torch.tensor([1.0, -1.0, 1.0], dtype=proj_verts.dtype, device=proj_verts.device)
    shift = torch.tensor([0.0, 0.0, HOGAN_EYE_Z], dtype=proj_verts.dtype, device=proj_verts.device)
    return proj_verts * flip + shift


def vertices_to_faces(vertices: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """(B, V, 3) vertices, (F, 3) or (B, F, 3) face ids -> (B, F, 3, 3).
    Negative (padding) ids read vertex 0; callers mask them by face validity.
    The vertex gradient adds in a fixed order (`gather_rows_nhwc`)."""
    if faces.dim() == 2:
        faces = faces[None].expand(vertices.shape[0], -1, -1)
    b, f, _ = faces.shape
    safe = faces.long().clamp(0, vertices.shape[1] - 1).reshape(b, f * 3)
    return gather_rows_nhwc(vertices, safe).reshape(b, f, 3, 3)


def proj_func(points: torch.Tensor, transl: torch.Tensor, rot: torch.Tensor,
              center: torch.Tensor, focal: float = 5000.0) -> torch.Tensor:
    """Fixed-focal perspective projection (reference hmr.py:13-42): rotate and
    translate, pinhole-project with focal 5000, shift by `center`, then
    /255 * 2 - 1. points (B, N, 3), transl (B, 3), rot (B, 3, 3), center (B, 2)."""
    cam = torch.einsum("bij,bnj->bni", rot, points) + transl[:, None]
    xy = cam[..., :2] / cam[..., 2:3]
    img = xy * focal + center[:, None, :]
    return img / 255.0 * 2.0 - 1.0
