"""Unified-surface-space renderer.

Port of hoig_tpu/geometry/renderer.py (reference utils/nmr.py MANORenderer):
padded per-object tables indexed by an integer object id, the packed
per-face attribute rows that ride the rasterizer's finish gather, the
barycentric warp (a `gather_rows` call) and the texture backward warp on the
serving path; off it, the separate encodings, the flow and occlusion maps,
silhouettes, depth and the generic textured RGB render. Every run-time hard
map goes through `rasterize_fim_wim_auto`: the B2 and B3 kernels on CUDA
tensors (the UV atlases are rasterized on the CPU when the tables are built).
"""

from __future__ import annotations

import dataclasses
import pickle

import numpy as np
import torch
import torch.nn.functional as F

from hoig_torch.geometry import mesh as mesh_utils
from hoig_torch.geometry.projection import (
    HOGAN_EYE_Z,
    orthographic_proj_withz_fxfy,
    orthographic_proj_withz_idrot,
    to_view_space,
    vertices_to_faces,
)
from hoig_torch.ops._cuda import resolve_device
from hoig_torch.ops.grid_sample import avg_pool, grid_sample, grid_sample_packed
from hoig_torch.ops.morph import morph
from hoig_torch.ops.rasterizer import rasterize_fim_wim
from hoig_torch.ops.rasterizer_cuda import rasterize_fim_wim_auto
from hoig_torch.ops.table_gather import gather_rows
from hoig_torch.ops.texture import lighting as apply_lighting
from hoig_torch.ops.texture import sample_textures_trilinear

NUM_HAND_VERTS = 778
NUM_HAND_FACES = 1538

# unified surface space: hand S | gap S/2 | object S
ATLAS_MEAN = np.array([1.25, 0.5], np.float32)
ATLAS_SCALE = np.array([0.8, -2.0], np.float32)
OBJ_ATLAS_SHIFT = 1.5

SEM_HAND_PARTS = ("palm", "thumb", "index_finger", "middle_finger", "ring_finger",
                  "little_finger")


@dataclasses.dataclass
class ObjectSpec:
    """One rigid object: mesh path and, optionally, its texture image (any
    size; read with cv2 and resized to the table's image size)."""

    name: str
    obj_path: str
    texture_path: str | None = None


@dataclasses.dataclass
class SurfaceTables:
    """Padded per-object tables (numpy); `as_torch(device)` moves them."""

    faces: np.ndarray  # (O, Fmax, 3) int32, -1 padded
    face_valid: np.ndarray  # (O, Fmax) bool
    num_faces: np.ndarray  # (O,) int32
    num_verts: np.ndarray  # (O,) int32 (hand + object)
    map_fn: np.ndarray  # (O, Fmax+1, 3); padding rows and last row = bg
    sem: np.ndarray  # (O, Fmax+1, 1)
    fim_uv: np.ndarray  # (O, S, 2.5 S) int32
    wim_uv: np.ndarray  # (O, S, 2.5 S, 3)
    faces_uv_coord: np.ndarray  # (O, Fmax, 3, 2)
    obj_tex: np.ndarray  # (O, 3, S, S) in [-1, 1]
    object_names: list

    def as_torch(self, device="cuda") -> dict:
        dev = resolve_device(device)
        names = ("faces", "face_valid", "num_faces", "map_fn", "sem", "fim_uv", "wim_uv",
                 "faces_uv_coord", "obj_tex")
        return {k: torch.as_tensor(getattr(self, k), device=dev) for k in names}


def _rasterize_uv_atlas(vts01: np.ndarray, faces_vts: np.ndarray, image_size: int):
    """Rasterize a UV chart (plain rasterizer, CPU, at table-build time)."""
    v = (vts01 - 0.5) * 2.0
    verts = np.concatenate([v, np.full((v.shape[0], 1), 1.0 + HOGAN_EYE_Z, np.float32)], axis=1)
    fv = torch.from_numpy(np.ascontiguousarray(verts[faces_vts][None]))
    fim, wim = rasterize_fim_wim(fv, image_size=image_size)
    return fim[0].numpy(), wim[0].numpy()


def _object_texture(path: str | None, image_size: int) -> np.ndarray:
    """(3, S, S) texture in [-1, 1], RGB; zeros for an untextured object."""
    if path is None:
        return np.zeros((3, image_size, image_size), np.float32)
    import cv2

    img = cv2.imread(path)
    if img is None:
        raise FileNotFoundError(f"cannot read the object texture {path}")
    img = cv2.resize(img[:, :, ::-1], (image_size, image_size))
    return (img.astype(np.float32) / 255.0 * 2.0 - 1.0).transpose(2, 0, 1)


def build_surface_tables(hand_uv_obj_path: str, objects: list, sem_hand: dict | str,
                         map_name: str = "uv_seg", image_size: int = 256,
                         obj_shift_per_index: bool = True) -> SurfaceTables:
    """All per-object static tables, as hoig_tpu's build_surface_tables."""
    if isinstance(sem_hand, str):
        with open(sem_hand, "rb") as fp:
            sem_hand = pickle.load(fp)

    hand_info = mesh_utils.load_obj(hand_uv_obj_path)
    hand_faces = hand_info["faces"]
    hand_map_fn = mesh_utils.create_mapping(map_name, hand_uv_obj_path, contain_bg=True)
    hand_sem = np.zeros((NUM_HAND_FACES, 1), np.float32)
    for i, key in enumerate(SEM_HAND_PARTS):
        hand_sem[np.asarray(sem_hand["right"][key])] = i + 1
    hand_fim, hand_wim = _rasterize_uv_atlas(hand_info["vts"], hand_info["faces_vts"], image_size)
    hand_uv_coord = hand_info["vts"][hand_info["faces_vts"]]

    per_obj = []
    for i, spec in enumerate(objects):
        info = mesh_utils.load_obj(spec.obj_path)
        faces = np.concatenate([hand_faces, info["faces"] + NUM_HAND_VERTS], axis=0)
        obj_map_fn = mesh_utils.create_mapping(map_name, spec.obj_path, contain_bg=True)
        shift = OBJ_ATLAS_SHIFT * (i + 1 if obj_shift_per_index else 1)
        obj_map_fn[:-1, :2] = obj_map_fn[:-1, :2] + np.array([shift, 0.0], np.float32)
        sem = np.concatenate(
            [hand_sem, np.full((info["faces"].shape[0], 1), i + 7, np.float32),
             np.zeros((1, 1), np.float32)],
            axis=0,
        )
        obj_fim, obj_wim = _rasterize_uv_atlas(info["vts"], info["faces_vts"], image_size)
        gap = image_size // 2
        fim_uv = np.concatenate(
            [hand_fim, -np.ones((image_size, gap), np.int32),
             np.where(obj_fim >= 0, obj_fim + NUM_HAND_FACES, -1)],
            axis=1,
        )
        wim_uv = np.concatenate([hand_wim, np.zeros((image_size, gap, 3), np.float32), obj_wim],
                                axis=1)
        obj_uv_coord = info["vts"][info["faces_vts"]] + np.array([OBJ_ATLAS_SHIFT, 0.0], np.float32)
        uv_coord = np.concatenate([hand_uv_coord, obj_uv_coord], axis=0)
        per_obj.append(dict(
            faces=faces, nf=faces.shape[0], nv=NUM_HAND_VERTS + info["vertices"].shape[0],
            map_fn=np.concatenate([hand_map_fn[:-1], obj_map_fn], axis=0), sem=sem,
            fim_uv=fim_uv, wim_uv=wim_uv,
            faces_uv_coord=(uv_coord - ATLAS_MEAN) * ATLAS_SCALE,
            obj_tex=_object_texture(spec.texture_path, image_size),
        ))

    n_obj = len(per_obj)
    f_max = max(o["nf"] for o in per_obj)
    faces_t = -np.ones((n_obj, f_max, 3), np.int32)
    valid_t = np.zeros((n_obj, f_max), bool)
    map_t = np.zeros((n_obj, f_max + 1, hand_map_fn.shape[1]), np.float32)
    sem_t = np.zeros((n_obj, f_max + 1, 1), np.float32)
    uvc_t = np.zeros((n_obj, f_max, 3, 2), np.float32)
    for j, o in enumerate(per_obj):
        nf = o["nf"]
        faces_t[j, :nf] = o["faces"]
        valid_t[j, :nf] = True
        # rows past a sample's face count resolve to its background row
        map_t[j, :nf] = o["map_fn"][:-1]
        map_t[j, nf:] = o["map_fn"][-1]
        sem_t[j, :nf] = o["sem"][:-1]
        sem_t[j, nf:] = o["sem"][-1]
        uvc_t[j, :nf] = o["faces_uv_coord"]
    return SurfaceTables(
        faces=faces_t,
        face_valid=valid_t,
        num_faces=np.array([o["nf"] for o in per_obj], np.int32),
        num_verts=np.array([o["nv"] for o in per_obj], np.int32),
        map_fn=map_t,
        sem=sem_t,
        fim_uv=np.stack([o["fim_uv"] for o in per_obj]).astype(np.int32),
        wim_uv=np.stack([o["wim_uv"] for o in per_obj]).astype(np.float32),
        faces_uv_coord=uvc_t,
        obj_tex=np.stack([o["obj_tex"] for o in per_obj]).astype(np.float32),
        object_names=[s.name for s in objects],
    )


def build_attr_table(tables: dict, obj_ids: torch.Tensor,
                     extra_f2pts: torch.Tensor | None = None) -> torch.Tensor:
    """(B, Fmax+1, 10|16) per-face rows [map_fn(3) | sem(1) | atlas uv
    corners(6) [| extra face-corner xy(6)]]; row Fmax is the background."""
    ids = obj_ids.long()
    b = ids.shape[0]
    map_fn = tables["map_fn"][ids]
    sem = tables["sem"][ids]
    f_max = map_fn.shape[1] - 1
    uvc = tables["faces_uv_coord"][ids].reshape(b, f_max, 6)
    pad_row = lambda a: F.pad(a, (0, 0, 0, 1))
    parts = [map_fn, sem, pad_row(uvc)]
    if extra_f2pts is not None:
        parts.append(pad_row(extra_f2pts.reshape(b, f_max, 6)))
    return torch.cat(parts, dim=-1)


def _corner_warp(corner_cols: torch.Tensor, wim: torch.Tensor, exist: torch.Tensor) -> torch.Tensor:
    """sum_k wim[..., k] * corner k, -2 where no face. corner_cols (B,H,W,6)."""
    b, s1, s2 = exist.shape
    c = corner_cols.reshape(b, s1, s2, 3, 2)
    t = c[..., 0, :] * wim[..., 0:1] + c[..., 1, :] * wim[..., 1:2] + c[..., 2, :] * wim[..., 2:3]
    return torch.where(exist[..., None], t, -2.0)


def split_encoded_rows(rows: torch.Tensor, fim: torch.Tensor, wim: torch.Tensor):
    """Per-pixel attribute rows -> (cond (B,3,S,S), sem (B,1,S,S),
    t_uv (B,S,S,2), t_extra (B,S,S,2) | None)."""
    cond = rows[..., :3].permute(0, 3, 1, 2)
    semm = rows[..., 3:4].permute(0, 3, 1, 2)
    exist = fim >= 0
    t_uv = _corner_warp(rows[..., 4:10], wim, exist)
    t_extra = _corner_warp(rows[..., 10:16], wim, exist) if rows.shape[-1] > 10 else None
    return cond, semm, t_uv, t_extra


def _barycentric_warp(f2pts: torch.Tensor, fim: torch.Tensor, wim: torch.Tensor):
    """T[p] = sum_k wim[p, k] * f2pts[fim[p], k]; the per-pixel 6-float rows
    come through `gather_rows`. Returns T (B,H,W,2) with -2 fill, exist."""
    b, h, w = fim.shape
    exist = fim >= 0
    idx = fim.clamp_min(0).reshape(b, h * w).to(torch.int32).contiguous()
    rows = gather_rows(f2pts.reshape(b, -1, 6).contiguous(), idx)  # (B, 6, N)
    return _corner_warp(rows.transpose(1, 2).reshape(b, h, w, 6), wim, exist), exist


def _occlusion_from_fim(t: torch.Tensor, exist: torch.Tensor, dst_fim: torch.Tensor,
                        src_fim: torch.Tensor) -> torch.Tensor:
    """3x3 visibility test: a destination pixel is occluded if none of the 9
    (edge-clamped) source pixels around its warped location carry its face."""
    b, h, w = dst_fim.shape
    s = src_fim.shape[-1]
    tc = t.clamp(-1.0, 1.0)
    px = ((tc[..., 0] + 1.0) * 0.5 * (s - 1)).floor().clamp(0, s - 1).long()
    py = ((tc[..., 1] + 1.0) * 0.5 * (s - 1)).floor().clamp(0, s - 1).long()
    flat = src_fim.reshape(b, s * s)
    visible = torch.zeros_like(exist)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            q = (py + dy).clamp(0, s - 1) * s + (px + dx).clamp(0, s - 1)
            visible |= torch.gather(flat, 1, q.reshape(b, -1)).reshape(b, h, w) == dst_fim
    return (exist & ~visible).float()[..., None]


def _occlusion_and_sample(t, exist, dst_fim, src_fim, im):
    """Occlusion test plus the align_corners=False bilinear source fetch
    (the JAX package fuses both into one TPU row gather; same values)."""
    return (_occlusion_from_fim(t, exist, dst_fim, src_fim),
            grid_sample_packed(im, t, align_corners=False))


def get_texture_backward_warp(tables: dict, im: torch.Tensor, src_f2pts: torch.Tensor,
                              src_fim: torch.Tensor, obj_ids: torch.Tensor,
                              pre_load: bool = True) -> torch.Tensor:
    """Source image -> unified surface texture (B, 3, S, 2.5 S).

    Occluded atlas texels are opened (erode + dilate, ks=3) and white-filled.
    With pre_load the object half is the registered texture, so only the hand
    columns plus a 2-column morph margin are warped and the face-free gap is
    exact zeros (the JAX package's reasoning, renderer.py:612-628)."""
    ids = obj_ids.long()
    atlas_w = tables["fim_uv"].shape[-1]
    keep, gap_w = atlas_w, 0
    if pre_load:
        hand_w = tables["fim_uv"].shape[-2]
        gap_w = atlas_w - tables["obj_tex"].shape[-1] - hand_w
        keep = hand_w
    m = min(keep + 2, atlas_w)
    fim_uv = tables["fim_uv"][ids][:, :, :m]
    wim_uv = tables["wim_uv"][ids][:, :, :m]

    t, exist = _barycentric_warp(src_f2pts, fim_uv, wim_uv)
    o, syn_tex = _occlusion_and_sample(t, exist, fim_uv, src_fim, im)
    o = morph(o.permute(0, 3, 1, 2), ks=3, mode="erode")
    o = 1.0 - morph(1.0 - o, ks=3, mode="erode")
    syn_tex = syn_tex * (1.0 - o) + o
    if pre_load:
        obj_tex = tables["obj_tex"][ids]
        gap = torch.zeros(syn_tex.shape[:3] + (gap_w,), dtype=syn_tex.dtype, device=syn_tex.device)
        syn_tex = torch.cat([syn_tex[..., :keep], gap, obj_tex], dim=3)
    return syn_tex


# ---------------------------------------------------------------------------
# Off the serving path: separate encodings, flow, silhouettes, depth and the
# generic texture / RGB render (nmr.py:420-475, 496-760)
# ---------------------------------------------------------------------------


def _project(tables: dict, cam, verts, obj_ids, image_size: int, camera_model: str):
    """-> (crop-NDC projection (B, V, 3), view-space face corners (B, F, 3, 3),
    faces (B, F, 3), face validity (B, F))."""
    proj_fn = (orthographic_proj_withz_idrot if camera_model == "matrix"
               else orthographic_proj_withz_fxfy)
    proj = proj_fn(verts, cam, image_size=image_size)
    ids = obj_ids.long()
    faces, valid = tables["faces"][ids], tables["face_valid"][ids]
    return proj, vertices_to_faces(to_view_space(proj), faces), faces, valid


def render_fim_wim(tables: dict, cam: torch.Tensor, verts: torch.Tensor, obj_ids: torch.Tensor,
                   image_size: int = 256, camera_model: str = "matrix", near: float = 0.1,
                   far: float = 25.0):
    """Project and rasterize (nmr.py:496-513).

    cam (B, 15) camMat + crop ('matrix', HOv3) or (B, 10) ('fxfy', DexYCB);
    verts (B, V, 3) hand ++ object vertices; obj_ids (B,). Returns f2pts
    (B, Fmax, 3, 2) per-face projected xy in crop NDC (y not flipped), fim
    (B, S, S) int32 and wim (B, S, S, 3)."""
    proj, face_verts, faces, valid = _project(tables, cam, verts, obj_ids, image_size,
                                              camera_model)
    fim, wim = rasterize_fim_wim_auto(face_verts, valid, image_size=image_size, near=near,
                                      far=far)
    return vertices_to_faces(proj, faces)[..., 0:2], fim, wim


def _bg_gather_index(fim: torch.Tensor, f_max: int) -> torch.Tensor:
    """fim -1 -> the background row f_max."""
    return torch.where(fim < 0, f_max, fim).long()


def _gather_pixel_rows(table: torch.Tensor, fim: torch.Tensor) -> torch.Tensor:
    """(B, Fmax+1, C) rows at each pixel's face (background row for -1) ->
    (B, S, S, C)."""
    b, s1, s2 = fim.shape
    idx = _bg_gather_index(fim, table.shape[1] - 1).reshape(b, s1 * s2, 1)
    return torch.take_along_dim(table, idx, dim=1).reshape(b, s1, s2, -1)


def encode_fim(tables: dict, obj_ids: torch.Tensor, fim: torch.Tensor) -> torch.Tensor:
    """fim -> condition map (B, C, S, S) (nmr.py:567-581)."""
    return _gather_pixel_rows(tables["map_fn"][obj_ids.long()], fim).permute(0, 3, 1, 2)


def encode_sem(tables: dict, obj_ids: torch.Tensor, fim: torch.Tensor) -> torch.Tensor:
    """fim -> semantic id map (B, 1, S, S) (nmr.py:583-595)."""
    return _gather_pixel_rows(tables["sem"][obj_ids.long()], fim).permute(0, 3, 1, 2)


def encode_and_warp(tables: dict, obj_ids: torch.Tensor, fim: torch.Tensor, wim: torch.Tensor,
                    extra_f2pts: torch.Tensor | None = None):
    """encode_fim, encode_sem and the atlas (and optional extra) barycentric
    warps from one row gather of `build_attr_table`'s rows. Returns (cond
    (B,3,S,S), sem (B,1,S,S), t_uv (B,S,S,2), t_extra (B,S,S,2) | None)."""
    rows = _gather_pixel_rows(build_attr_table(tables, obj_ids, extra_f2pts), fim)
    return split_encoded_rows(rows, fim, wim)


def cal_bc_transform(src_f2pts: torch.Tensor, src_fim: torch.Tensor, dst_fim: torch.Tensor,
                     dst_wim: torch.Tensor):
    """Destination pixel -> source-image flow and occlusion (nmr.py:874-968).
    Returns T (B, S, S, 2) in source NDC, -2 where no face, and O (B, S, S, 1)
    in {0, 1}."""
    t, exist = _barycentric_warp(src_f2pts, dst_fim, dst_wim)
    return t, _occlusion_from_fim(t, exist, dst_fim, src_fim)


def sample_from_texture_dense(tables: dict, fim: torch.Tensor, wim: torch.Tensor,
                              obj_ids: torch.Tensor) -> torch.Tensor:
    """fim / wim -> atlas sampling grid (B, S, S, 2) (nmr.py:1068-1100)."""
    t, _ = _barycentric_warp(tables["faces_uv_coord"][obj_ids.long()], fim, wim)
    return t


def sample_from_texture(cond: torch.Tensor) -> torch.Tensor:
    """Sparse condition map (B, C, H, W) -> atlas grid (B, 2, H, W)
    (nmr.py:1060-1066): -2 where the uv is zero."""
    uv = cond[:, :2]
    kw = dict(dtype=uv.dtype, device=uv.device)
    mean = torch.tensor(ATLAS_MEAN, **kw)[None, :, None, None]
    scale = torch.tensor([0.8, 2.0], **kw)[None, :, None, None]
    nonzero = (uv != 0).to(uv.dtype)
    return nonzero * (uv - mean) * scale + (1.0 - nonzero) * (-2.0)


def render_silhouettes(tables: dict, cam, verts, obj_ids, image_size: int = 256,
                       camera_model: str = "matrix") -> torch.Tensor:
    """Coverage mask (B, S, S) through the shared projection (nmr.py:533-549)."""
    _, fim, _ = render_fim_wim(tables, cam, verts, obj_ids, image_size, camera_model)
    return (fim >= 0).float()


def render_depth(tables: dict, cam, verts, obj_ids, image_size: int = 256,
                 camera_model: str = "matrix") -> torch.Tensor:
    """View-space depth map (B, S, S), near 0.1, far 25 (nmr.py:515-531)."""
    _, face_verts, _, valid = _project(tables, cam, verts, obj_ids, image_size, camera_model)
    return rasterize_fim_wim_auto(face_verts, valid, image_size=image_size, near=0.1, far=25.0,
                                  depth=True)[2]


def create_coords(tex_size: int = 3, device="cuda") -> torch.Tensor:
    """(2, T*T) barycentric sample grid (nmr.py:731-746), on the card unless
    the caller passes device="cpu"."""
    step = 1.0 if tex_size == 1 else 1.0 / (tex_size - 1)
    ab = np.arange(0, 1 + step, step, dtype=np.float32)
    xv, yv = np.meshgrid(ab, ab, indexing="ij")
    return torch.as_tensor(np.stack([xv.ravel(), yv.ravel()], axis=0),
                           device=resolve_device(device))


def create_meshgrid(image_size: int, device="cuda") -> torch.Tensor:
    """(S, S, 2) sampling grid in [-1, 1] with the reference's (y, x)
    stacking (nmr.py:749-760), on the card unless the caller passes
    device="cpu"."""
    factor = (np.arange(image_size, dtype=np.float32) / (image_size - 1) - 0.5) * 2
    xv, yv = np.meshgrid(factor, factor, indexing="ij")
    return torch.as_tensor(np.stack([yv, xv], axis=-1), device=resolve_device(device))


def points_to_sampler(coords: torch.Tensor, faces_pts: torch.Tensor) -> torch.Tensor:
    """Per-face barycentric sample points (nmr.py:709-728): coords (2, T*T),
    faces_pts (B, F, 3, 2) -> (B, F, T*T, 2) clamped to [-1, 1]."""
    v2 = faces_pts[:, :, 2]
    basis = torch.stack([faces_pts[:, :, 0] - v2, faces_pts[:, :, 1] - v2], dim=-1)  # (B,F,2,2)
    samples = torch.einsum("bfct,tk->bfck", basis, coords) + v2[..., None]
    return samples.permute(0, 1, 3, 2).clamp(-1.0, 1.0)


def batch_orth_proj_idrot(camera: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Weak-perspective projection (nmr.py:691-706), camera (B, 3) = [s, tx, ty]."""
    return camera[:, None, 0:1] * (pts[:, :, :2] + camera[:, None, 1:])


def extract_tex(uv_img: torch.Tensor, uv_sampler: torch.Tensor, tex_size: int) -> torch.Tensor:
    """Image -> per-face texture cubes (nmr.py:608-629): uv_img (B, 3, H, W),
    uv_sampler (B, F, T*T, 2) -> (B, F, T, T, T, 3), constant along the
    fourth axis."""
    tex = grid_sample(uv_img, uv_sampler, align_corners=True)  # (B, 3, F, T*T)
    b, _, nf, _ = tex.shape
    t = tex_size
    tex = tex.reshape(b, 3, nf, t, t).permute(0, 2, 3, 4, 1)
    return tex[:, :, :, :, None, :].expand(-1, -1, -1, -1, t, -1).contiguous()


def dynamic_sampler(tables: dict, cam_weak, vertices, obj_ids, tex_size: int = 3):
    """Weak-perspective per-face UV sampler (nmr.py:631-637)."""
    points = batch_orth_proj_idrot(cam_weak, vertices)
    faces = tables["faces"][obj_ids.long()]
    faces_pts = vertices_to_faces(torch.cat([points, torch.zeros_like(points[..., :1])], -1),
                                  faces)[..., :2]
    return points_to_sampler(create_coords(tex_size, device=vertices.device), faces_pts)


def extract_tex_from_image(tables: dict, images, cam_weak, vertices, obj_ids,
                           tex_size: int = 3):
    """Per-face texture cubes read from images (nmr.py:598-606)."""
    return extract_tex(images, dynamic_sampler(tables, cam_weak, vertices, obj_ids, tex_size),
                       tex_size)


def render_rgb(tables: dict, cam: torch.Tensor, verts: torch.Tensor, textures: torch.Tensor,
               obj_ids: torch.Tensor, image_size: int = 256, camera_model: str = "matrix",
               anti_aliasing: bool = True, background_color=(0.0, 0.0, 0.0),
               light: dict | None = None) -> torch.Tensor:
    """RGB render (nmr.py:439-475): lighting, projection, rasterization at 2S
    with anti_aliasing, trilinear texture sampling, 2x2 average pooling.
    textures (B, F, T, T, T, 3) over the object's merged face table.
    Returns (B, 3, S, S)."""
    proj, face_verts, faces, valid = _project(tables, cam, verts, obj_ids, image_size,
                                              camera_model)
    textures = apply_lighting(vertices_to_faces(verts, faces), textures, **(light or {}))
    s = image_size * 2 if anti_aliasing else image_size
    fim, wim = rasterize_fim_wim_auto(face_verts, valid, image_size=s, near=0.1, far=25.0)
    rgb = sample_textures_trilinear(textures, fim, wim, background_color).permute(0, 3, 1, 2)
    return avg_pool(rgb, 2) if anti_aliasing else rgb
