"""Textured OBJ IO: an MTL texture image <-> per-face texture cubes.

Port of hoig_tpu/geometry/obj_io.py (the neural renderer's load_textures and
create_texture_image with save_obj). Host-side numpy: it runs once per OBJ.

PNG textures are read and written with the port's stdlib codec
(hoig_torch.utils.util.read_png / encode_png), so no cv2 or PIL is needed for
them. Another image format imports cv2 when it is met and raises, naming the
file, where cv2 is missing. Writing the texture PNG can fail only with the
file system's own error: a textured OBJ is never written without its
texture (the JAX package passes over a failed cv2.imwrite).
"""

from __future__ import annotations

import os

import numpy as np

from hoig_torch.geometry.mesh import load_obj
from hoig_torch.utils.util import read_png, save_image


def _barycentric_cube(tex_size: int) -> np.ndarray:
    """(T, T, T, 3) barycentric weights per texel: (i, j, k) / (i + j + k),
    uniform at the origin."""
    idx = np.stack(np.meshgrid(*([np.arange(tex_size)] * 3), indexing="ij"),
                   axis=-1).astype(np.float64)
    s = idx.sum(-1, keepdims=True)
    return np.where(s > 0, idx / np.maximum(s, 1), 1.0 / 3.0).astype(np.float32)


def _bilinear_sample_image(img: np.ndarray, uv: np.ndarray) -> np.ndarray:
    """img (H, W, 3) float; uv (..., 2) in [0, 1], v from the bottom as an
    OBJ's vt -> (..., 3)."""
    h, w = img.shape[:2]
    x = np.clip(uv[..., 0], 0, 1) * (w - 1)
    y = (1.0 - np.clip(uv[..., 1], 0, 1)) * (h - 1)
    x0 = np.floor(x).astype(np.int64)
    y0 = np.floor(y).astype(np.int64)
    x1 = np.minimum(x0 + 1, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    tx = (x - x0)[..., None]
    ty = (y - y0)[..., None]
    return (img[y0, x0] * (1 - tx) * (1 - ty) + img[y0, x1] * tx * (1 - ty)
            + img[y1, x0] * (1 - tx) * ty + img[y1, x1] * tx * ty)


def load_textures_from_image(texture_img: np.ndarray, vts: np.ndarray, faces_vts: np.ndarray,
                             tex_size: int = 3) -> np.ndarray:
    """-> (F, T, T, T, 3) float32 per-face texture cubes, sampled at the
    barycentric mixes of each face's UV corners. texture_img (H, W, 3) in
    [0, 1] (or [0, 255]: passed through)."""
    corners = vts[faces_vts]  # (F, 3, 2)
    w = _barycentric_cube(tex_size).reshape(-1, 3)
    uv = np.einsum("tk,fkc->ftc", w, corners)
    tex = _bilinear_sample_image(texture_img.astype(np.float32), uv)
    return tex.reshape(corners.shape[0], tex_size, tex_size, tex_size, 3).astype(np.float32)


def _read_texture(path: str) -> np.ndarray:
    """(H, W, 3) RGB float32 in [0, 1]."""
    if path.lower().endswith(".png"):
        return read_png(path).astype(np.float32) / 255.0
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"the texture {path} is not a PNG, and reading it needs cv2, "
                          "which is not installed") from e
    img = cv2.imread(path)
    if img is None:
        raise FileNotFoundError(f"cv2 cannot read the texture {path}")
    return img[:, :, ::-1].astype(np.float32) / 255.0


def load_obj_with_textures(obj_path: str, tex_size: int = 3):
    """nr.load_obj(load_texture=True): the OBJ and the per-face cubes of its
    MTL's map_Kd image (all ones where the OBJ names no texture or the files
    are absent, as the JAX package does). Returns (info, (F, T, T, T, 3))."""
    info = load_obj(obj_path)
    tex_img = None
    mtl_name = None
    with open(obj_path) as fp:
        for line in fp:
            if line.startswith("mtllib"):
                mtl_name = line.split()[1]
                break
    if mtl_name:
        mtl_path = os.path.join(os.path.dirname(obj_path), mtl_name)
        if os.path.exists(mtl_path):
            with open(mtl_path) as fp:
                for line in fp:
                    if line.strip().startswith("map_Kd"):
                        img_path = os.path.join(os.path.dirname(obj_path), line.split()[-1])
                        if os.path.exists(img_path):
                            tex_img = _read_texture(img_path)
                        break
    if tex_img is None:
        textures = np.ones((info["faces"].shape[0], tex_size, tex_size, tex_size, 3), np.float32)
    else:
        textures = load_textures_from_image(tex_img, info["vts"], info["faces_vts"], tex_size)
    return info, textures


def create_texture_image(textures: np.ndarray, texture_size_out: int = 16):
    """Per-face textures (F, T, T, T, 3) -> (atlas image (H, W, 3), per-face
    vt coordinates (F, 3, 2) in [0, 1]). Each face gets a square cell, filled
    from the nearest texels of its cube along the cell's barycentric chart."""
    f, t = textures.shape[0], textures.shape[1]
    tile = texture_size_out
    cols = int(np.ceil(np.sqrt(f)))
    rows = int(np.ceil(f / cols))
    img = np.zeros((rows * tile, cols * tile, 3), np.float32)
    vts = np.zeros((f, 3, 2), np.float32)

    ys, xs = np.meshgrid(np.arange(tile), np.arange(tile), indexing="ij")
    a = xs / max(tile - 1, 1)
    b = ys / max(tile - 1, 1)
    w0 = np.clip(1.0 - a - b, 0.0, 1.0)
    w1 = np.clip(a, 0.0, 1.0)
    w2 = np.clip(b, 0.0, 1.0)
    s = w0 + w1 + w2
    w = np.stack([w0 / s, w1 / s, w2 / s], axis=-1)
    pos = np.clip(w * (t - 1), 0, t - 1)
    i0 = np.round(pos).astype(np.int64)

    h_img = img.shape[0]
    for i in range(f):
        r, c = divmod(i, cols)
        img[r * tile:(r + 1) * tile, c * tile:(c + 1) * tile] = \
            textures[i][i0[..., 0], i0[..., 1], i0[..., 2]]
        x0, y0 = c * tile, r * tile
        corners_px = np.array([[x0, y0], [x0 + tile - 1, y0], [x0, y0 + tile - 1]], np.float32)
        vts[i, :, 0] = corners_px[:, 0] / (img.shape[1] - 1)
        vts[i, :, 1] = 1.0 - corners_px[:, 1] / (h_img - 1)
    return img, vts


def save_obj_textured(path: str, vertices: np.ndarray, faces: np.ndarray,
                      textures: np.ndarray | None = None, texture_size_out: int = 16) -> None:
    """Write an OBJ; with textures also its MTL and PNG atlas (the pixels
    cv2.imwrite would write: (img * 255) clipped, truncated to uint8)."""
    base = os.path.splitext(path)[0]
    with open(path, "w") as fp:
        if textures is not None:
            fp.write(f"mtllib {os.path.basename(base)}.mtl\n")
        for v in vertices:
            fp.write(f"v {v[0]} {v[1]} {v[2]}\n")
        if textures is None:
            for f in faces:
                fp.write(f"f {f[0] + 1} {f[1] + 1} {f[2] + 1}\n")
            return
        img, vts = create_texture_image(textures, texture_size_out)
        for tri in vts:
            for (u, v) in tri:
                fp.write(f"vt {u} {v}\n")
        fp.write("usemtl material_1\n")
        for i, f in enumerate(faces):
            t = i * 3
            fp.write(f"f {f[0] + 1}/{t + 1} {f[1] + 1}/{t + 2} {f[2] + 1}/{t + 3}\n")
    with open(base + ".mtl", "w") as fp:
        fp.write("newmtl material_1\nmap_Kd {}.png\n".format(os.path.basename(base)))
    save_image((img * 255).clip(0, 255).astype(np.uint8), base + ".png")
