"""The benchmark's inputs, all drawn from one seed: the MANO stand-in, the
object meshes, the hand UV chart, the semantics, the pose and image pools
and the networks' weights.

A frozen copy of the generators of the port's synthetic environment (the
shapes and distributions of `hoig_torch/data/synthetic.py` and
`MANOModel.synthetic`), so that a later change to the program cannot move
what the benchmark feeds it. Both the program and the plain reference get
exactly these inputs; each builds its own face tables from the mesh files.
Meshes go to a directory under TMPDIR that lives as long as the `Assets`.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile

import numpy as np
import torch

NUM_VERTS = 778
NUM_JOINTS = 16
NUM_SHAPE = 10
NUM_POSE = 45
NUM_HAND_FACES = 1538
MANO_PARENTS = np.array([-1, 0, 1, 2, 0, 4, 5, 0, 7, 8, 0, 10, 11, 0, 13, 14], np.int32)
SEM_PARTS = ("palm", "thumb", "index_finger", "middle_finger", "ring_finger", "little_finger")


def sub_seeds(seed: int, n: int) -> list:
    """n independent 32-bit seeds from one seed of any size."""
    return [int(s) for s in np.random.SeedSequence(int(seed)).generate_state(n)]


def mano_standin(seed: int) -> dict:
    """A MANO model with the real tensor shapes (numpy), as the port's
    synthetic stand-in draws it."""
    rng = np.random.RandomState(seed)
    u = rng.rand(NUM_VERTS) * 2 * np.pi
    v = rng.rand(NUM_VERTS) * np.pi
    v_template = np.stack([0.1 * np.cos(u) * np.sin(v), 0.04 * np.sin(u) * np.sin(v),
                           0.03 * np.cos(v)], axis=-1).astype(np.float32)
    j_reg = np.abs(rng.randn(NUM_JOINTS, NUM_VERTS)).astype(np.float32)
    j_reg /= j_reg.sum(axis=1, keepdims=True)
    w = np.abs(rng.randn(NUM_VERTS, NUM_JOINTS)).astype(np.float32)
    w /= w.sum(axis=1, keepdims=True)
    comps = np.linalg.qr(rng.randn(NUM_POSE, NUM_POSE))[0].astype(np.float32)
    faces = rng.randint(0, NUM_VERTS, (NUM_HAND_FACES, 3)).astype(np.int32)
    return dict(
        v_template=v_template,
        shapedirs=(rng.randn(NUM_VERTS, 3, NUM_SHAPE) * 0.01).astype(np.float32),
        posedirs=(rng.randn(NUM_VERTS, 3, NUM_POSE * 3) * 0.001).astype(np.float32),
        j_regressor=j_reg,
        lbs_weights=w,
        parents=MANO_PARENTS.copy(),
        hands_components=comps,
        hands_mean=(rng.randn(NUM_POSE) * 0.1).astype(np.float32),
        faces=faces,
    )


def _grid_uv_rows(n_faces: int) -> list:
    """Non-overlapping per-face UV triangles on a grid."""
    cols = int(np.ceil(np.sqrt(n_faces)))
    rows = int(np.ceil(n_faces / cols))
    du, dv = 1.0 / cols, 1.0 / rows
    m = 0.15
    out = []
    for i in range(n_faces):
        r, c = divmod(i, cols)
        u0, v0 = c * du, r * dv
        out.append([(u0 + m * du, v0 + m * dv), (u0 + (1 - m) * du, v0 + m * dv),
                    (u0 + 0.5 * du, v0 + (1 - m) * dv)])
    return out


def _write_obj(path: str, verts: np.ndarray, faces: np.ndarray, z: float = 0.0) -> None:
    uv_tris = _grid_uv_rows(len(faces))
    with open(path, "w") as f:
        for p in verts:
            f.write(f"v {p[0]} {p[1]} {p[2] + z}\n")
        for tri in uv_tris:
            for (u, v) in tri:
                f.write(f"vt {u} {v}\n")
        for i, s in enumerate(faces):
            t = i * 3
            f.write(f"f {s[0]+1}/{t+1} {s[1]+1}/{t+2} {s[2]+1}/{t+3}\n")


def object_mesh(seed: int, n_verts: int = 40) -> tuple:
    """A random convex blob (YCB-like layout): (vertices, faces)."""
    from scipy.spatial import ConvexHull

    pts = np.random.RandomState(seed).randn(n_verts, 3) * 0.05
    return pts, ConvexHull(pts).simplices


def semantics(seed: int) -> dict:
    """All 1538 hand faces partitioned into the 6 parts."""
    chunks = np.array_split(np.random.RandomState(seed).permutation(NUM_HAND_FACES), len(SEM_PARTS))
    return {"right": {k: c for k, c in zip(SEM_PARTS, chunks)}}


@dataclasses.dataclass
class Assets:
    """The scene's files and host arrays: hand UV chart and object meshes
    under `root` (a directory under TMPDIR), the MANO stand-in, the
    semantics, each object's vertices about its centre (the poses place
    them) and its face count."""

    root: str
    hand_uv_path: str
    object_paths: list
    mano: dict
    sem: dict
    obj_verts: list
    obj_faces: list
    _tmp: tempfile.TemporaryDirectory

    def close(self) -> None:
        self._tmp.cleanup()


def make_assets(seed: int, num_objects: int) -> Assets:
    s_mano, s_sem, s_obj = sub_seeds(seed, 3)
    mano = mano_standin(s_mano)
    tmp = tempfile.TemporaryDirectory(prefix="hoig_bench_")
    hand = os.path.join(tmp.name, "hand_uv.obj")
    _write_obj(hand, mano["v_template"], mano["faces"])
    paths, verts, n_faces = [], [], []
    for i, s in enumerate(sub_seeds(s_obj, num_objects)):
        pts, faces = object_mesh(s)
        p = os.path.join(tmp.name, f"obj{i:02d}.obj")
        _write_obj(p, pts, faces, z=0.6)
        paths.append(p)
        verts.append(pts.astype(np.float32))
        n_faces.append(len(faces))
    return Assets(tmp.name, hand, paths, mano, semantics(s_sem), verts, n_faces, tmp)


def theta_pool(n: int, obj_verts: list, seed: int, camera: str, image_size: int,
               obj_id: np.ndarray | None = None) -> dict:
    """n rows of MANO + object pose parameters (numpy), as the port's
    synthetic poses draw them; obj_id fixed where given (a pair's two poses
    share the object)."""
    rng = np.random.RandomState(seed)
    f = 500.0 * image_size / 256.0
    c = 128.0 * image_size / 256.0
    row = [f, 0, c, 0, f, c, 0, 0, 1] if camera == "matrix" else [f, f, c, c]
    cam = np.tile(np.array(row, np.float32), (n, 1))
    if obj_id is None:
        obj_id = rng.randint(0, len(obj_verts), n).astype(np.int32)
    v_max = max(v.shape[0] for v in obj_verts)
    vobj = np.zeros((n, v_max, 3), np.float32)
    for i in range(n):
        v = obj_verts[obj_id[i]]
        vobj[i, : v.shape[0]] = v + rng.randn(3).astype(np.float32) * 0.01 + [0, 0, 0.55]
    return dict(
        cam=cam,
        trans=np.tile(np.eye(2, 3, dtype=np.float32)[None], (n, 1, 1)),
        pose=(rng.randn(n, 48) * 0.1).astype(np.float32),
        shape=(rng.randn(n, 10) * 0.3).astype(np.float32),
        handtrans=np.tile(np.array([[0, 0, 0.5]], np.float32), (n, 1)),
        vertices_obj=vobj,
        obj_id=obj_id,
    )


def device_generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def make_pool(n: int, assets: Assets, seed: int, camera: str, image_size: int, with_masks: bool,
              device) -> dict:
    """A pool of n source / target rows on the device: images in [-1, 1]
    and binary masks drawn there in a few large calls, the pose pairs drawn
    on the host (a few KB a row) and copied once."""
    s_a, s_b, s_img = sub_seeds(seed, 3)
    gen = device_generator(s_img, device)
    s = image_size
    images = torch.rand((2, n, 3, s, s), generator=gen, device=device) * 2 - 1
    pool = dict(imageA=images[0], imageB=images[1])
    if with_masks:
        masks = (torch.rand((2, n, 1, s, s), generator=gen, device=device) > 0.5).float()
        pool.update(maskA=masks[0], maskB=masks[1])
    mano_a = theta_pool(n, assets.obj_verts, s_a, camera, s)
    mano_b = theta_pool(n, assets.obj_verts, s_b, camera, s, obj_id=mano_a["obj_id"])
    as_dev = lambda d: {k: torch.as_tensor(v, device=device) for k, v in d.items()}
    pool.update(manoA=as_dev(mano_a), manoB=as_dev(mano_b))
    return pool


def take(pool: dict, rows: torch.Tensor) -> dict:
    """The batch of the pool's `rows` (a device index tensor)."""
    return {k: ({kk: vv.index_select(0, rows) for kk, vv in v.items()} if isinstance(v, dict)
                else v.index_select(0, rows)) for k, v in pool.items()}


class RowOrder:
    """Which pool rows feed each step or call: consecutive slices of seeded
    permutations of the pool, so that no row repeats within a pass."""

    def __init__(self, pool_rows: int, batch: int, seed: int, device):
        if pool_rows % batch:
            raise ValueError(f"the pool's {pool_rows} rows are not a whole number of batches "
                             f"of {batch}")
        self.pool_rows, self.batch = pool_rows, batch
        self._gen = device_generator(seed, device)
        self._device = device
        self._perm = None
        self._next = 0

    def __call__(self) -> torch.Tensor:
        if self._perm is None or self._next == self.pool_rows:
            self._perm = torch.randperm(self.pool_rows, generator=self._gen, device=self._device)
            self._next = 0
        rows = self._perm[self._next:self._next + self.batch]
        self._next += self.batch
        return rows


def conv_init_kinds(named_shapes: list) -> list:
    """(name, shape, kind) with kind 'normal' (conv and linear weights,
    N(0, 0.02)), 'ones' (norm scales) or 'zeros' (biases): the reference
    networks' initialisation."""
    out = []
    for name, shape in named_shapes:
        if name.endswith(".bias"):
            kind = "zeros"
        elif len(shape) >= 2:
            kind = "normal"
        else:
            kind = "ones"
        out.append((name, tuple(shape), kind))
    return out


def make_weights(named_shapes: list, seed: int, device) -> dict:
    """{name: f32 tensor} for every parameter, drawn on the device in one
    call: one normal draw for all conv weights, sliced in list order."""
    specs = conv_init_kinds(named_shapes)
    total = sum(int(np.prod(s)) for _, s, k in specs if k == "normal")
    flat = torch.randn(total, generator=device_generator(seed, device), device=device) * 0.02
    out, at = {}, 0
    for name, shape, kind in specs:
        if kind == "normal":
            n = int(np.prod(shape))
            out[name] = flat[at:at + n].view(shape)
            at += n
        elif kind == "ones":
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out
