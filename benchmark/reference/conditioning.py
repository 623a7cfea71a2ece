"""Plain PyTorch conditioning: face tables from the mesh files, MANO
skinning, projection, a dense z-buffer rasterizer, the attribute finish, the
barycentric and texture warps and the generator's input assembly.

A frozen copy of the plain mathematics of the HOGAN conditioning
(HandRecoveryFlow: models/trainer.py and utils/nmr.py of the reference) as
the port computes it, with no kernel, gather or table of the port: every
gather is `torch.gather`, the rasterizer is one dense reduction over faces.
Tensors are NCHW except the flow T (B, S, S, 2).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.precision import FULL, Precision

NUM_HAND_VERTS = 778
NUM_HAND_FACES = 1538
ATLAS_MEAN = np.array([1.25, 0.5], np.float32)
ATLAS_SCALE = np.array([0.8, -2.0], np.float32)
OBJ_ATLAS_SHIFT = 1.5
EYE_Z = float(1.0 / np.tan(np.radians(30.0)) + 1.0)
SEM_PARTS = ("palm", "thumb", "index_finger", "middle_finger", "ring_finger", "little_finger")
FINGERTIPS = (745, 317, 444, 556, 673)
PARENTS = (-1, 0, 1, 2, 0, 4, 5, 0, 7, 8, 0, 10, 11, 0, 13, 14)
_BIG = 1e10


# ----------------------------------------------------------------- meshes


def load_obj(path: str) -> dict:
    verts, vts, faces, faces_vts = [], [], [], []
    with open(path) as fp:
        for line in fp:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(v) for v in parts[1:4]])
            elif parts[0] == "vt":
                vts.append([float(v) for v in parts[1:3]])
            elif parts[0] == "f":
                idx = [p.split("/") for p in parts[1:]]
                for k in range(1, len(idx) - 1):
                    tri = [idx[0], idx[k], idx[k + 1]]
                    faces.append([int(p[0]) - 1 for p in tri])
                    faces_vts.append([int(p[1]) - 1 for p in tri])
    return dict(vertices=np.asarray(verts, np.float32).reshape(-1, 3),
                vts=np.asarray(vts, np.float32).reshape(-1, 2),
                faces=np.asarray(faces, np.int32).reshape(-1, 3),
                faces_vts=np.asarray(faces_vts, np.int32).reshape(-1, 3))


def uv_seg_map(info: dict) -> np.ndarray:
    """Face -> (u, 1 - v, 0) barycentre of its UV corners, plus the
    background row (0, 0, 1)."""
    vts = info["vts"].copy()
    vts[:, 1] = 1.0 - vts[:, 1]
    f2 = np.concatenate([vts, np.zeros((len(vts), 1), np.float32)], axis=1)[info["faces_vts"]]
    v2 = f2[:, 2]
    bary = v2 + 0.5 * (f2[:, 0] - v2) + 0.5 * (f2[:, 1] - v2)
    return np.concatenate([bary.astype(np.float32), [[0.0, 0.0, 1.0]]], axis=0).astype(np.float32)


def uv_atlas(vts: np.ndarray, faces_vts: np.ndarray, s: int):
    """A UV chart rasterized (on the CPU) at s x s: fim (s, s), wim (s, s, 3)."""
    v = (vts - 0.5) * 2.0
    verts = np.concatenate([v, np.full((len(v), 1), 1.0 + EYE_Z, np.float32)], axis=1)
    fv = torch.from_numpy(np.ascontiguousarray(verts[faces_vts][None]))
    fim, wim, _ = rasterize(fv, None, s, 0.1, 100.0, None)
    return fim[0].numpy(), wim[0].numpy()


def build_tables(hand_uv_path: str, object_paths: list, sem: dict, s: int, device) -> dict:
    """Padded per-object tables on `device`: faces (O, F, 3), face_valid,
    map_fn (O, F+1, 3), sem (O, F+1, 1), fim_uv / wim_uv (O, S, 2.5 S[, 3]),
    faces_uv_coord (O, F, 3, 2), obj_tex (O, 3, S, S)."""
    hand = load_obj(hand_uv_path)
    hand_map = uv_seg_map(hand)
    hand_sem = np.zeros((NUM_HAND_FACES, 1), np.float32)
    for i, key in enumerate(SEM_PARTS):
        hand_sem[np.asarray(sem["right"][key])] = i + 1
    hand_fim, hand_wim = uv_atlas(hand["vts"], hand["faces_vts"], s)
    hand_uvc = hand["vts"][hand["faces_vts"]]
    objs = []
    for i, path in enumerate(object_paths):
        info = load_obj(path)
        obj_map = uv_seg_map(info)
        obj_map[:-1, :2] += np.array([OBJ_ATLAS_SHIFT * (i + 1), 0.0], np.float32)
        ofim, owim = uv_atlas(info["vts"], info["faces_vts"], s)
        gap = s // 2
        objs.append(dict(
            faces=np.concatenate([hand["faces"], info["faces"] + NUM_HAND_VERTS]),
            map_fn=np.concatenate([hand_map[:-1], obj_map]),
            sem=np.concatenate([hand_sem, np.full((len(info["faces"]), 1), i + 7, np.float32),
                                np.zeros((1, 1), np.float32)]),
            fim_uv=np.concatenate([hand_fim, -np.ones((s, gap), np.int32),
                                   np.where(ofim >= 0, ofim + NUM_HAND_FACES, -1)], axis=1),
            wim_uv=np.concatenate([hand_wim, np.zeros((s, gap, 3), np.float32), owim], axis=1),
            uvc=(np.concatenate([hand_uvc, info["vts"][info["faces_vts"]]
                                 + np.array([OBJ_ATLAS_SHIFT, 0.0], np.float32)])
                 - ATLAS_MEAN) * ATLAS_SCALE))
    n, f_max = len(objs), max(len(o["faces"]) for o in objs)
    faces = -np.ones((n, f_max, 3), np.int32)
    valid = np.zeros((n, f_max), bool)
    map_fn = np.zeros((n, f_max + 1, 3), np.float32)
    sem_t = np.zeros((n, f_max + 1, 1), np.float32)
    uvc = np.zeros((n, f_max, 3, 2), np.float32)
    for j, o in enumerate(objs):
        nf = len(o["faces"])
        faces[j, :nf], valid[j, :nf] = o["faces"], True
        map_fn[j, :nf], map_fn[j, nf:] = o["map_fn"][:-1], o["map_fn"][-1]
        sem_t[j, :nf], sem_t[j, nf:] = o["sem"][:-1], o["sem"][-1]
        uvc[j, :nf] = o["uvc"]
    host = dict(faces=faces, face_valid=valid, map_fn=map_fn, sem=sem_t,
                fim_uv=np.stack([o["fim_uv"] for o in objs]).astype(np.int32),
                wim_uv=np.stack([o["wim_uv"] for o in objs]).astype(np.float32),
                faces_uv_coord=uvc, obj_tex=np.zeros((n, 3, s, s), np.float32))
    return {k: torch.as_tensor(v, device=device) for k, v in host.items()}


# ------------------------------------------------------------------- MANO


def rodrigues(rvec):
    theta = torch.linalg.vector_norm(rvec, dim=-1, keepdim=True)
    n = rvec / theta.clamp_min(1e-8)
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    z = torch.zeros_like(nx)
    k = torch.stack([torch.stack([z, -nz, ny], -1), torch.stack([nz, z, -nx], -1),
                     torch.stack([-ny, nx, z], -1)], -2)
    t = theta[..., None]
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device)
    r = torch.cos(t) * eye + torch.sin(t) * k + (1.0 - torch.cos(t)) * (n[..., :, None] * n[..., None, :])
    return torch.where(t > 1e-8, r, eye + t * k)


def mano_vertices(m: dict, root, hand_pose, betas, transl=None):
    """Batched MANO linear blend skinning -> (B, 778, 3)."""
    b = root.shape[0]
    full = torch.cat([root, hand_pose], dim=1).reshape(b, 16, 3)
    v_shaped = m["v_template"] + torch.einsum("bl,vcl->bvc", betas, m["shapedirs"])
    joints = torch.einsum("jv,bvc->bjc", m["j_regressor"], v_shaped)
    rot = rodrigues(full)
    eye = torch.eye(3, dtype=rot.dtype, device=rot.device)
    v_posed = v_shaped + torch.einsum("bp,vcp->bvc", (rot[:, 1:] - eye).reshape(b, 135),
                                      m["posedirs"])
    rel = [joints[:, 0]] + [joints[:, i] - joints[:, PARENTS[i]] for i in range(1, 16)]
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=rot.dtype, device=rot.device).expand(b, 1, 4)
    tf = []
    for i in range(16):
        local = torch.cat([torch.cat([rot[:, i], rel[i][:, :, None]], dim=2), bottom], dim=1)
        tf.append(local if i == 0 else tf[PARENTS[i]] @ local)
    a = torch.stack(tf, dim=1)
    corr = torch.einsum("bjmn,bjn->bjm", a, torch.cat([joints, torch.zeros_like(joints[..., :1])], -1))
    a = a.clone()
    a[..., 3] = a[..., 3] - corr
    t_verts = torch.einsum("vj,bjmn->bvmn", m["lbs_weights"], a)
    verts = torch.einsum("bvmn,bvn->bvm", t_verts,
                         torch.cat([v_posed, torch.ones_like(v_posed[..., :1])], -1))[..., :3]
    return verts if transl is None else verts + transl[:, None, :]


def scene_vertices(m: dict, theta: dict, cfg: dict):
    """(cam (B, 15|10), hand + object vertices (B, 778 + V, 3))."""
    b = theta["cam"].shape[0]
    pose, handtrans = theta["pose"], theta["handtrans"]
    root, hand_pose = pose[:, :3], pose[:, 3:]
    if cfg["mano_pca_comps"] > 0:
        hand_pose = hand_pose @ m["hands_components"][:cfg["mano_pca_comps"]] + m["hands_mean"]
        verts = mano_vertices(m, root, hand_pose, theta["shape"]) + handtrans[:, None, :]
    else:
        if not cfg["mano_flat_hand_mean"]:
            hand_pose = hand_pose + m["hands_mean"]
        verts = mano_vertices(m, root, hand_pose, theta["shape"], transl=handtrans)
    cam = torch.cat([theta["cam"].reshape(b, -1), theta["trans"].reshape(b, -1)], dim=1)
    return cam, torch.cat([verts, theta["vertices_obj"]], dim=1)


def project(pts, cam, s: int, camera: str):
    """Crop-NDC projection (B, N, 3): the HO3Dv3 camera matrix (with the
    OpenGL flip) or the DexYCB fx / fy camera."""
    b = cam.shape[0]
    if camera == "matrix":
        k = cam[:, 0:9].reshape(b, 3, 3)
        trans = cam[:, 9:15].reshape(b, 2, 3)
        flipped = pts * torch.tensor([1.0, -1.0, -1.0], dtype=pts.dtype, device=pts.device)
        proj = torch.einsum("bnk,bmk->bnm", flipped, k)
        xy = proj[:, :, :2] / proj[:, :, 2:3]
        z = flipped[:, :, 2:3]
    else:
        f, c = cam[:, 0:2], cam[:, 2:4]
        trans = cam[:, 4:10].reshape(b, 2, 3)
        z = pts[:, :, 2:3]
        xy = pts[:, :, :2] / (z + 1e-8) * f[:, None, :] + c[:, None, :]
    xy1 = torch.cat([xy, torch.ones_like(xy[:, :, :1])], dim=2)
    xy = torch.einsum("bmk,bnk->bnm", trans, xy1) / float(s - 1) * 2.0 - 1.0
    return torch.cat([xy, z], dim=2)


def face_corners(verts, faces):
    """(B, V, 3), (B, F, 3) ids (negative = padding, reads vertex 0) -> (B, F, 3, 3)."""
    b, f, _ = faces.shape
    idx = faces.long().clamp(0, verts.shape[1] - 1).reshape(b, f * 3, 1).expand(-1, -1, 3)
    return torch.gather(verts, 1, idx).reshape(b, f, 3, 3)


# -------------------------------------------------------------- rasterizer


def _grids(s: int, device):
    ar = torch.arange(s, dtype=torch.float32, device=device)
    yi, xi = torch.meshgrid(ar, ar, indexing="ij")
    return (xi.reshape(-1), yi.reshape(-1), ((2.0 * xi + 1.0 - s) / s).reshape(-1),
            ((2.0 * yi + 1.0 - s) / s).reshape(-1))


def rasterize(face_verts, face_valid, s: int, near: float, far: float, attrs, chunk: int = 128):
    """Z-buffer (neural_renderer's rules: back faces culled by the signed
    area, pixel-centre inside test on the three edge lines, the largest
    inverse depth in (1/far, 1/near) wins, ties to the lowest face index,
    barycentrics at integer pixels clamped and renormalised, maps flipped
    vertically). Returns fim (B,S,S), wim (B,S,S,3), rows (B,S,S,A) | None."""
    fv = face_verts.float()
    x, y, z = fv[..., 0], fv[..., 1], fv[..., 2]
    keep = (y[..., 2] - y[..., 0]) * (x[..., 1] - x[..., 0]) >= (y[..., 1] - y[..., 0]) * (x[..., 2] - x[..., 0])
    if face_valid is not None:
        keep = keep & face_valid

    def edge(a, b):
        return torch.stack([-(y[..., b] - y[..., a]), x[..., b] - x[..., a],
                            x[..., a] * y[..., b] - y[..., a] * x[..., b]], dim=-1)

    edges = torch.stack([edge(0, 1), edge(1, 2), edge(2, 0)], dim=-2)
    px, py = 0.5 * (x * s + s - 1.0), 0.5 * (y * s + s - 1.0)
    den = px[..., 2] * (py[..., 0] - py[..., 1]) + px[..., 0] * (py[..., 1] - py[..., 2]) + px[..., 1] * (py[..., 2] - py[..., 0])
    den = torch.where(den.abs() < 1e-12, 1e-12, den)

    def row(a, b):
        return torch.stack([py[..., a] - py[..., b], px[..., b] - px[..., a],
                            px[..., a] * py[..., b] - px[..., b] * py[..., a]], dim=-1)

    finv = torch.stack([row(1, 2), row(2, 0), row(0, 1)], dim=-2) / den[..., None, None]
    inv_z = 1.0 / torch.where(z.abs() < 1e-12, 1e-12, z)
    izp = finv[..., 0, :] * inv_z[..., 0:1] + finv[..., 1, :] * inv_z[..., 1:2] + finv[..., 2, :] * inv_z[..., 2:3]

    b, f = keep.shape
    dev = fv.device
    xi, yi, xp, yp = _grids(s, dev)
    lo, hi = torch.tensor(1.0 / far, device=dev), torch.tensor(1.0 / near, device=dev)
    winners = []
    for bi in range(b):
        best = torch.full((s * s,), -_BIG, device=dev)
        arg = torch.full((s * s,), -1, dtype=torch.int32, device=dev)
        for base in range(0, f, chunk):
            e, zc = edges[bi, base:base + chunk], izp[bi, base:base + chunk]
            inside = ((xp[:, None, None] * e[None, :, :, 0] + yp[:, None, None] * e[None, :, :, 1]
                       + e[None, :, :, 2]) >= 0).all(dim=-1)
            iz = xi[:, None] * zc[None, :, 0] + yi[:, None] * zc[None, :, 1] + zc[None, :, 2]
            ok = inside & keep[bi, base:base + chunk][None] & (iz > lo) & (iz < hi)
            iz = torch.where(ok, iz, -_BIG)
            cbest = iz.amax(dim=1)
            ids = torch.arange(base, base + e.shape[0], dtype=torch.int32, device=dev)
            carg = torch.where(iz >= cbest[:, None], ids[None], 2**30).amin(dim=1)
            better = cbest > best
            best = torch.where(better, cbest, best)
            arg = torch.where(better & (cbest > -_BIG), carg, arg)
        winners.append(arg)
    idx = torch.stack(winners)

    hit = idx >= 0
    table = finv.reshape(b, f, 9)
    bg = torch.zeros((b, 1, 9), device=dev)
    if attrs is not None:
        table = torch.cat([table, attrs[:, :-1]], dim=2)
        bg = torch.cat([bg, attrs[:, -1:]], dim=2)
    table = torch.cat([table, bg], dim=1)
    safe = torch.where(hit, idx, f).long()
    fw = torch.gather(table, 1, safe[..., None].expand(-1, -1, table.shape[2])).transpose(1, 2)
    w = (fw[:, 0:9:3] * xi + fw[:, 1:9:3] * yi + fw[:, 2:9:3]).clamp(0.0, 1.0)
    w = w / (w[:, 0:1] + w[:, 1:2] + w[:, 2:3]).clamp_min(1e-12)
    fim = torch.where(hit, idx, -1).reshape(b, s, s).flip(1)
    wim = torch.where(hit[:, None], w, 0.0).transpose(1, 2).reshape(b, s, s, 3).flip(1)
    rows = None
    if attrs is not None:
        rows = fw[:, 9:].transpose(1, 2).reshape(b, s, s, -1).flip(1)
    return fim, wim, rows


# -------------------------------------------------------- sampling, morph


def grid_sample_nhwc(image, grid, align_corners: bool):
    """Bilinear sampling with zeros outside, torch's F.grid_sample rules:
    image (N, H, W, C), grid (N, Ho, Wo, 2) -> (N, Ho, Wo, C)."""
    n, h, w, c = image.shape

    def unnorm(v, size):
        return (v + 1.0) * 0.5 * (size - 1) if align_corners else ((v + 1.0) * size - 1.0) * 0.5

    gx, gy = unnorm(grid[..., 0].float(), w), unnorm(grid[..., 1].float(), h)
    x0, y0 = gx.floor(), gy.floor()
    tx, ty = gx - x0, gy - y0
    flat = image.reshape(n, h * w, c)
    out = None
    for dy, wy in ((0, 1.0 - ty), (1, ty)):
        yv = y0 + dy
        for dx, wx in ((0, 1.0 - tx), (1, tx)):
            xv = x0 + dx
            ok = (yv >= 0) & (yv <= h - 1) & (xv >= 0) & (xv <= w - 1)
            q = (yv.clamp(0, h - 1).long() * w + xv.clamp(0, w - 1).long()).reshape(n, -1, 1)
            val = torch.gather(flat, 1, q.expand(-1, -1, c))
            term = val * torch.where(ok, wy * wx, 0.0).reshape(n, -1, 1).to(image.dtype)
            out = term if out is None else out + term
    return out.reshape(n, grid.shape[1], grid.shape[2], c)


def grid_sample_nchw(image, grid, align_corners: bool):
    return grid_sample_nhwc(image.permute(0, 2, 3, 1), grid, align_corners).permute(0, 3, 1, 2)


def morph(mask, ks: int, mode: str):
    """Erode (pad 1, all of the window) or dilate (pad 0, any of it)."""
    pad = ks // 2
    shape = mask.shape
    x = F.pad(mask.reshape(-1, 1, shape[-2], shape[-1]), (pad,) * 4,
              value=1.0 if mode == "erode" else 0.0)
    summed = F.avg_pool2d(x, ks, stride=1, divisor_override=1)
    return (summed >= (ks * ks - 0.5 if mode == "erode" else 0.5)).to(mask.dtype).reshape(shape)


def _corner_warp(cols, wim, exist):
    b, s1, s2 = exist.shape
    c = cols.reshape(b, s1, s2, 3, 2)
    t = c[..., 0, :] * wim[..., 0:1] + c[..., 1, :] * wim[..., 1:2] + c[..., 2, :] * wim[..., 2:3]
    return torch.where(exist[..., None], t, -2.0)


def texture_backward_warp(tables, im, src_f2pts, src_fim, ids):
    """Source image -> unified surface texture (B, 3, S, 2.5 S): the hand
    columns (plus a 2-column morph margin) warped from the image, occluded
    texels opened and white-filled, the gap zero, the object half the
    registered texture."""
    atlas_w = tables["fim_uv"].shape[-1]
    hand_w = tables["fim_uv"].shape[-2]
    gap_w = atlas_w - tables["obj_tex"].shape[-1] - hand_w
    m = min(hand_w + 2, atlas_w)
    fim_uv, wim_uv = tables["fim_uv"][ids][:, :, :m], tables["wim_uv"][ids][:, :, :m]
    b, h, w = fim_uv.shape
    exist = fim_uv >= 0
    idx = fim_uv.clamp_min(0).reshape(b, h * w, 1).long().expand(-1, -1, 6)
    rows = torch.gather(src_f2pts.reshape(b, -1, 6), 1, idx)
    t = _corner_warp(rows.reshape(b, h, w, 6), wim_uv, exist)
    # occluded where none of the 9 source pixels around the warped point carries the face
    s = src_fim.shape[-1]
    tc = t.clamp(-1.0, 1.0)
    px = ((tc[..., 0] + 1.0) * 0.5 * (s - 1)).floor().clamp(0, s - 1).long()
    py = ((tc[..., 1] + 1.0) * 0.5 * (s - 1)).floor().clamp(0, s - 1).long()
    flat = src_fim.reshape(b, s * s)
    visible = torch.zeros_like(exist)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            q = (py + dy).clamp(0, s - 1) * s + (px + dx).clamp(0, s - 1)
            visible |= torch.gather(flat, 1, q.reshape(b, -1)).reshape(b, h, w) == fim_uv
    o = (exist & ~visible).float()[:, None]
    tex = grid_sample_nchw(im, t, align_corners=False)
    o = morph(o, 3, "erode")
    o = 1.0 - morph(1.0 - o, 3, "erode")
    tex = tex * (1.0 - o) + o
    gap = torch.zeros(tex.shape[:3] + (gap_w,), dtype=tex.dtype, device=tex.device)
    return torch.cat([tex[..., :hand_w], gap, tables["obj_tex"][ids]], dim=3)


def _split_cond(cond):
    hand = (cond[:, :1] < 1.5).to(cond.dtype)
    obj = (cond[:, :1] > 1.5).to(cond.dtype)
    return (torch.cat([hand * cond[:, :2], cond[:, 2:] + 1.0 - hand], dim=1),
            torch.cat([obj * cond[:, :2], cond[:, 2:] + 1.0 - obj], dim=1))


def _onehot(ids, num: int):
    return torch.cat([(ids == i).float() for i in range(1, num + 1)], dim=1)


def _not_hand(fim):
    is_hand = (fim >= 0) & (fim < NUM_HAND_FACES)
    return morph(1.0 - is_hand[:, None].float(), 3, "erode")


@torch.no_grad()
def hand_recovery_flow(tables: dict, mano: dict, batch: dict, cfg: dict,
                       prec: Precision = FULL) -> dict:
    """The full conditioning pass on one batch -> the generator's inputs and
    the crop masks (NCHW) and the flow T (B, S, S, 2)."""
    src_img, ref_img = batch["imageA"], batch["imageB"]
    s, b = cfg["image_size"], src_img.shape[0]
    both = {k: torch.cat([batch["manoA"][k], batch["manoB"][k]]) for k in batch["manoA"]}
    cam, verts = scene_vertices(mano, both, cfg)
    ids = batch["manoA"]["obj_id"].long()
    ids2 = torch.cat([ids, ids])
    proj = prec.geometry(project(verts, cam, s, cfg["camera_model"]))
    view = proj * torch.tensor([1.0, -1.0, 1.0], device=proj.device) + torch.tensor(
        [0.0, 0.0, EYE_Z], device=proj.device)
    faces2 = tables["faces"][ids2]
    f2pts = face_corners(proj, faces2)[..., 0:2]
    src_f2pts = f2pts[:b]
    f_max = tables["map_fn"].shape[1] - 1
    pad_row = lambda a: F.pad(a, (0, 0, 0, 1))
    attrs = torch.cat([tables["map_fn"][ids2], tables["sem"][ids2],
                       pad_row(tables["faces_uv_coord"][ids2].reshape(2 * b, f_max, 6)),
                       pad_row(torch.cat([src_f2pts, src_f2pts]).reshape(2 * b, f_max, 6))], -1)
    fim, wim, rows = rasterize(face_corners(view, faces2), tables["face_valid"][ids2], s, 0.1,
                               25.0, attrs)
    exist = fim >= 0
    cond2 = rows[..., :3].permute(0, 3, 1, 2)
    sem2 = rows[..., 3:4].permute(0, 3, 1, 2)
    t_uv2 = _corner_warp(rows[..., 4:10], wim, exist)
    t_flow = _corner_warp(rows[..., 10:16], wim, exist)[b:]
    src_fim, ref_fim = fim[:b], fim[b:]
    src_cond, ref_cond = cond2[:b], cond2[b:]
    src_seg, ref_seg = _onehot(sem2[:b], 15), _onehot(sem2[b:], 15)
    src_mh, ref_mh = _not_hand(src_fim), _not_hand(ref_fim)
    t_hand = torch.where(ref_mh[:, 0][..., None] == 0, t_flow, -2.0)
    tex = texture_backward_warp(tables, src_img, src_f2pts, src_fim, ids)
    render_ref = grid_sample_nchw(tex, t_uv2[b:], align_corners=True)
    render_src = grid_sample_nchw(tex, t_uv2[:b], align_corners=True)
    src_mbg = morph(src_cond[:, -1:], 3, "erode")
    ref_mbg = morph(ref_cond[:, -1:], 3, "erode")
    src_ch, src_co = _split_cond(src_cond)
    ref_ch, ref_co = _split_cond(ref_cond)
    fxfy = cfg["camera_model"] == "fxfy"
    bg_mask = morph(src_cond[:, -1:], 15, "erode")
    return {
        "input_G_src_bg": torch.cat([src_img * bg_mask, bg_mask], dim=1),
        "input_G_src_obj": torch.cat([render_src * (src_mh - src_mbg), src_co, src_seg[:, 6:]], 1),
        "input_G_tsf_obj": torch.cat([render_ref * (ref_mh - ref_mbg), ref_co, ref_seg[:, 6:]], 1),
        "input_G_src_hand": torch.cat([src_img * (1.0 - src_mh), src_ch]
                                      + ([src_seg[:, :6]] if fxfy else []), 1),
        "input_G_tsf_hand": torch.cat([render_ref * (1.0 - ref_mh), ref_ch]
                                      + ([ref_seg[:, :6]] if fxfy else []), 1),
        "T": t_hand,
        "src_crop_mask_bg": src_mbg,
        "tsf_crop_mask_bg": ref_mbg,
        "src_crop_mask_hand": src_mh,
        "tsf_crop_mask_hand": ref_mh,
    }


def mano_tensors(mano: dict, device) -> dict:
    keys = ("v_template", "shapedirs", "posedirs", "j_regressor", "lbs_weights",
            "hands_components", "hands_mean")
    return {k: torch.as_tensor(mano[k], device=device) for k in keys}
