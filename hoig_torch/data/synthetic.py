"""Synthetic fixtures: objects, hand UV chart, semantics, batches.

Port of hoig_tpu/data/synthetic.py: the same numpy seeds give the same
meshes, tables, poses and images, so both packages can be fed one batch.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

from hoig_torch.geometry.mano import MANOModel
from hoig_torch.geometry.renderer import ObjectSpec, build_surface_tables


def _grid_uv_rows(n_faces: int):
    """Non-overlapping per-face UV triangles on a grid."""
    cols = int(np.ceil(np.sqrt(n_faces)))
    rows = int(np.ceil(n_faces / cols))
    du, dv = 1.0 / cols, 1.0 / rows
    out = []
    m = 0.15  # margin inside each cell so rasterized faces don't touch
    for i in range(n_faces):
        r, c = divmod(i, cols)
        u0, v0 = c * du, r * dv
        out.append([
            (u0 + m * du, v0 + m * dv),
            (u0 + (1 - m) * du, v0 + m * dv),
            (u0 + 0.5 * du, v0 + (1 - m) * dv),
        ])
    return out


def write_synthetic_obj(path: str, n_verts: int = 40, seed: int = 0, z: float = 0.6):
    """Random convex blob with a per-face grid UV chart, YCB-like layout."""
    from scipy.spatial import ConvexHull

    rng = np.random.RandomState(seed)
    pts = rng.randn(n_verts, 3) * 0.05
    faces = ConvexHull(pts).simplices
    uv_tris = _grid_uv_rows(len(faces))
    with open(path, "w") as f:
        for p in pts:
            f.write(f"v {p[0]} {p[1]} {p[2] + z}\n")
        for tri in uv_tris:
            for (u, v) in tri:
                f.write(f"vt {u} {v}\n")
        for i, s in enumerate(faces):
            t = i * 3
            f.write(f"f {s[0]+1}/{t+1} {s[1]+1}/{t+2} {s[2]+1}/{t+3}\n")
    return pts


def write_hand_uv_obj(path: str, model: MANOModel):
    uv_tris = _grid_uv_rows(len(model.faces))
    with open(path, "w") as f:
        for v in model.v_template:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for tri in uv_tris:
            for (u, v) in tri:
                f.write(f"vt {u} {v}\n")
        for i, fc in enumerate(model.faces):
            t = i * 3
            f.write(f"f {fc[0]+1}/{t+1} {fc[1]+1}/{t+2} {fc[2]+1}/{t+3}\n")


def synthetic_semantics(seed: int = 11) -> dict:
    """All 1538 hand faces partitioned into the 6 parts."""
    rng = np.random.RandomState(seed)
    keys = ["palm", "thumb", "index_finger", "middle_finger", "ring_finger", "little_finger"]
    chunks = np.array_split(rng.permutation(1538), len(keys))
    return {"right": {k: c for k, c in zip(keys, chunks)}}


def synthetic_environment(num_objects: int = 2, image_size: int = 256, seed: int = 0,
                          device="cuda") -> dict:
    """Tables, MANO model and object vertices, host-side and on `device`.

    Returns dict(tables_np, tables, mano, mano_params, obj_verts). The mesh
    files are written to a temporary directory that is removed after the
    tables are built."""
    mano = MANOModel.synthetic(seed)
    specs, verts = [], []
    with tempfile.TemporaryDirectory(prefix="hoig_synth_") as d:
        hand_path = os.path.join(d, "hand_uv.obj")
        write_hand_uv_obj(hand_path, mano)
        for i in range(num_objects):
            p = os.path.join(d, f"obj{i}.obj")
            verts.append(write_synthetic_obj(p, seed=seed + i))
            specs.append(ObjectSpec(name=f"{i:03d}_synthetic", obj_path=p))
        tables_np = build_surface_tables(hand_path, specs, synthetic_semantics(),
                                         image_size=image_size)
    return dict(tables_np=tables_np, tables=tables_np.as_torch(device), mano=mano,
                mano_params=mano.as_torch(device), obj_verts=verts)


def synthetic_theta(batch_size: int, obj_verts, seed: int = 0, camera: str = "matrix",
                    image_size: int = 256) -> dict:
    """Random MANO + object pose parameters shaped like the dataset output (numpy)."""
    rng = np.random.RandomState(seed)
    b = batch_size
    f = 500.0 * image_size / 256.0
    c = 128.0 * image_size / 256.0
    if camera == "matrix":
        cam = np.tile(np.array([f, 0, c, 0, f, c, 0, 0, 1], np.float32), (b, 1))
    else:
        cam = np.tile(np.array([f, f, c, c], np.float32), (b, 1))
    obj_id = rng.randint(0, len(obj_verts), b).astype(np.int32)
    v_max = max(v.shape[0] for v in obj_verts)
    vobj = np.zeros((b, v_max, 3), np.float32)
    for i in range(b):
        v = obj_verts[obj_id[i]]
        vobj[i, : v.shape[0]] = v + rng.randn(3).astype(np.float32) * 0.01 + [0, 0, 0.55]
    return dict(
        cam=cam,
        trans=np.tile(np.eye(2, 3, dtype=np.float32)[None], (b, 1, 1)),
        pose=(rng.randn(b, 48) * 0.1).astype(np.float32),
        shape=(rng.randn(b, 10) * 0.3).astype(np.float32),
        handtrans=np.tile(np.array([[0, 0, 0.5]], np.float32), (b, 1)),
        vertices_obj=vobj,
        obj_id=obj_id,
    )


def synthetic_batch(batch_size: int, obj_verts, image_size: int = 256, seed: int = 0,
                    with_masks: bool = True, camera: str = "matrix") -> dict:
    """A numpy batch: imageA/B (B,3,S,S) in [-1,1], manoA/B, maskA/B."""
    rng = np.random.RandomState(seed)
    b = batch_size
    batch = dict(
        imageA=(rng.rand(b, 3, image_size, image_size) * 2 - 1).astype(np.float32),
        imageB=(rng.rand(b, 3, image_size, image_size) * 2 - 1).astype(np.float32),
        manoA=synthetic_theta(b, obj_verts, seed=seed * 2 + 1, image_size=image_size,
                              camera=camera),
        manoB=synthetic_theta(b, obj_verts, seed=seed * 2 + 2, image_size=image_size,
                              camera=camera),
    )
    # pairs share the object identity (same video clip in the reference)
    batch["manoB"]["obj_id"] = batch["manoA"]["obj_id"]
    if with_masks:
        batch["maskA"] = (rng.rand(b, 1, image_size, image_size) > 0.5).astype(np.float32)
        batch["maskB"] = (rng.rand(b, 1, image_size, image_size) > 0.5).astype(np.float32)
    return batch
