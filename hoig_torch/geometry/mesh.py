"""OBJ loading and face -> condition mapping tables (numpy, build time only).

A copy of hoig_tpu/geometry/mesh.py (reference utils/mesh.py: load_obj,
get_f2vts, create_mapping, get_map_fn_dim; save_obj from utils/nmr.py).
"""

from __future__ import annotations

import numpy as np


def load_obj(path: str) -> dict:
    """Parse an OBJ file (v/vt/vn and f v/vt/vn forms, polygons fan-split).

    Returns float32 'vertices' (V,3), 'vts' (T,2), 'vns' (N,3) and int32
    'faces', 'faces_vts', 'faces_vns' (F,3); empty where the OBJ lacks them.
    """
    verts, vts, vns = [], [], []
    faces, faces_vts, faces_vns = [], [], []
    with open(path, "r") as fp:
        for line in fp:
            parts = line.strip().split()
            if not parts:
                continue
            tag = parts[0]
            if tag == "v":
                verts.append([float(v) for v in parts[1:4]])
            elif tag == "vt":
                vts.append([float(v) for v in parts[1:3]])
            elif tag == "vn":
                vns.append([float(v) for v in parts[1:4]])
            elif tag == "f":
                idx = [p.split("/") for p in parts[1:]]
                for k in range(1, len(idx) - 1):
                    tri = [idx[0], idx[k], idx[k + 1]]
                    faces.append([int(p[0]) - 1 for p in tri])
                    if all(len(p) > 1 and p[1] for p in tri):
                        faces_vts.append([int(p[1]) - 1 for p in tri])
                    if all(len(p) > 2 and p[2] for p in tri):
                        faces_vns.append([int(p[2]) - 1 for p in tri])
    return {
        "vertices": np.asarray(verts, dtype=np.float32).reshape(-1, 3),
        "vts": np.asarray(vts, dtype=np.float32).reshape(-1, 2),
        "vns": np.asarray(vns, dtype=np.float32).reshape(-1, 3),
        "faces": np.asarray(faces, dtype=np.int32).reshape(-1, 3),
        "faces_vts": np.asarray(faces_vts, dtype=np.int32).reshape(-1, 3),
        "faces_vns": np.asarray(faces_vns, dtype=np.int32).reshape(-1, 3),
    }


def save_obj(verts: np.ndarray, faces: np.ndarray, path: str) -> None:
    """Write a minimal OBJ: `v` lines, then 1-based `f` lines."""
    with open(path, "w") as fp:
        for v in verts:
            fp.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for f in faces:
            fp.write(f"f {f[0] + 1} {f[1] + 1} {f[2] + 1}\n")


def compute_barycenter(f2vts: np.ndarray) -> np.ndarray:
    """(F, 3, C) corner attributes -> (F, C): v2 + 0.5 (v0 - v2) + 0.5 (v1 - v2)."""
    v2 = f2vts[:, 2]
    return v2 + 0.5 * (f2vts[:, 0] - v2) + 0.5 * (f2vts[:, 1] - v2)


def get_f2vts(obj_path: str) -> np.ndarray:
    """Per-face UV corners (u, 1 - v, 0), (F, 3, 3)."""
    info = load_obj(obj_path)
    vts = info["vts"].copy()
    vts[:, 1] = 1.0 - vts[:, 1]
    vts3 = np.concatenate([vts, np.zeros((vts.shape[0], 1), dtype=np.float32)], axis=-1)
    return vts3[info["faces_vts"]]


def create_mapping(map_name: str, obj_path: str, contain_bg: bool = True) -> np.ndarray:
    """Face index -> condition vector table.

    'uv' -> (F[+1], 2), bg [-1, -1]; 'seg' -> (F[+1], 1), bg [0];
    'uv_seg' -> (F[+1], 3) UV barycentres (u, 1-v, 0), bg [0, 0, 1].
    """
    f2vts = get_f2vts(obj_path)
    nf = f2vts.shape[0]
    if map_name == "uv":
        map_fn = compute_barycenter(f2vts)[:, 0:2]
        bg = np.array([[-1.0, -1.0]], dtype=np.float32)
    elif map_name == "seg":
        map_fn = np.ones((nf, 1), dtype=np.float32)
        bg = np.array([[0.0]], dtype=np.float32)
    elif map_name == "uv_seg":
        map_fn = compute_barycenter(f2vts)
        bg = np.array([[0.0, 0.0, 1.0]], dtype=np.float32)
    else:
        raise ValueError(f"map name error {map_name}")
    if contain_bg:
        map_fn = np.concatenate([map_fn.astype(np.float32), bg], axis=0)
    return map_fn.astype(np.float32)


def get_map_fn_dim(map_name: str) -> int:
    """Condition channels per map type (utils/mesh.py:410-437): the
    conditioning widths of the generator and discriminator."""
    dims = {"seg": 1, "uv": 2, "uv_seg": 3, "par": 11, "ids": 1, "binary": 15}
    if map_name not in dims:
        raise ValueError(f"map name error {map_name}")
    return dims[map_name]
