"""MANO hand model: linear blend skinning in PyTorch.

Port of hoig_tpu/geometry/mano.py (smplx MANO with use_pca=False and the
manopth 45-component PCA front end). All products run in f32.
"""

from __future__ import annotations

import dataclasses
import pickle
import sys
import types

import numpy as np
import torch

from hoig_torch.geometry.projection import constant
from hoig_torch.ops._cuda import resolve_device

NUM_VERTS = 778
NUM_JOINTS = 16
NUM_SHAPE = 10
NUM_POSE = (NUM_JOINTS - 1) * 3  # 45

MANO_PARENTS = np.array([-1, 0, 1, 2, 0, 4, 5, 0, 7, 8, 0, 10, 11, 0, 13, 14], np.int32)
FINGERTIP_VERT_IDS = (745, 317, 444, 556, 673)


@dataclasses.dataclass
class MANOModel:
    """Host-side MANO parameters (numpy); `as_torch(device)` moves them."""

    v_template: np.ndarray  # (778, 3)
    shapedirs: np.ndarray  # (778, 3, 10)
    posedirs: np.ndarray  # (778, 3, 135)
    j_regressor: np.ndarray  # (16, 778)
    lbs_weights: np.ndarray  # (778, 16)
    parents: np.ndarray  # (16,)
    hands_components: np.ndarray  # (45, 45)
    hands_mean: np.ndarray  # (45,)
    faces: np.ndarray  # (1538, 3)

    @classmethod
    def from_pickle(cls, path: str) -> "MANOModel":
        """Load MANO_RIGHT.pkl (chumpy-array pickles load without chumpy)."""
        dd = _load_mano_pickle(path)
        kt = np.asarray(dd["kintree_table"])
        id_to_col = {int(kt[1, i]): i for i in range(kt.shape[1])}
        parents = np.array(
            [-1] + [id_to_col[int(kt[0, i])] for i in range(1, kt.shape[1])], np.int32
        )
        return cls(
            v_template=_to_np(dd["v_template"]).astype(np.float32),
            shapedirs=_to_np(dd["shapedirs"]).astype(np.float32),
            posedirs=_to_np(dd["posedirs"]).astype(np.float32),
            j_regressor=_to_np(dd["J_regressor"]).astype(np.float32),
            lbs_weights=_to_np(dd["weights"]).astype(np.float32),
            parents=parents,
            hands_components=_to_np(dd["hands_components"]).astype(np.float32),
            hands_mean=_to_np(dd["hands_mean"]).astype(np.float32),
            faces=_to_np(dd["f"]).astype(np.int32),
        )

    @classmethod
    def synthetic(cls, seed: int = 0) -> "MANOModel":
        """Deterministic stand-in with the real MANO tensor shapes (the same
        numbers as the JAX package's for the same seed)."""
        rng = np.random.RandomState(seed)
        u = rng.rand(NUM_VERTS) * 2 * np.pi
        v = rng.rand(NUM_VERTS) * np.pi
        v_template = np.stack(
            [0.1 * np.cos(u) * np.sin(v), 0.04 * np.sin(u) * np.sin(v), 0.03 * np.cos(v)],
            axis=-1,
        ).astype(np.float32)
        j_reg = np.abs(rng.randn(NUM_JOINTS, NUM_VERTS)).astype(np.float32)
        j_reg /= j_reg.sum(axis=1, keepdims=True)
        w = np.abs(rng.randn(NUM_VERTS, NUM_JOINTS)).astype(np.float32)
        w /= w.sum(axis=1, keepdims=True)
        comps = np.linalg.qr(rng.randn(NUM_POSE, NUM_POSE))[0].astype(np.float32)
        faces = rng.randint(0, NUM_VERTS, (1538, 3)).astype(np.int32)
        return cls(
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

    def as_torch(self, device="cuda") -> dict:
        dev = resolve_device(device)
        names = ("v_template", "shapedirs", "posedirs", "j_regressor", "lbs_weights",
                 "hands_components", "hands_mean")
        return {k: torch.as_tensor(getattr(self, k), device=dev) for k in names}


def _to_np(x) -> np.ndarray:
    if hasattr(x, "todense"):
        return np.asarray(x.todense())
    for attr in ("r", "x"):
        if hasattr(x, attr):
            return np.asarray(getattr(x, attr))
    return np.asarray(x)


class _ChStub:
    """Stand-in for chumpy.Ch so MANO pickles load without chumpy."""

    def __setstate__(self, state):
        self.__dict__.update(state)


def _load_mano_pickle(path: str) -> dict:
    try:
        with open(path, "rb") as fp:
            return pickle.load(fp, encoding="latin1")
    except ModuleNotFoundError as e:
        if "chumpy" not in str(e):
            raise
    mod = types.ModuleType("chumpy")
    mod.Ch = _ChStub
    ch_mod = types.ModuleType("chumpy.ch")
    ch_mod.Ch = _ChStub
    reordering = types.ModuleType("chumpy.reordering")
    for name in ("Select", "transpose", "reshape"):
        setattr(reordering, name, _ChStub)
    saved = {k: sys.modules.get(k) for k in ("chumpy", "chumpy.ch", "chumpy.reordering")}
    sys.modules.update({"chumpy": mod, "chumpy.ch": ch_mod, "chumpy.reordering": reordering})
    try:
        with open(path, "rb") as fp:
            return pickle.load(fp, encoding="latin1")
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v


def rodrigues(rvec: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrices (..., 3, 3), with a
    first-order fallback below 1e-8 rad."""
    theta = torch.linalg.vector_norm(rvec, dim=-1, keepdim=True)
    n = rvec / theta.clamp_min(1e-8)
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    zeros = torch.zeros_like(nx)
    k = torch.stack(
        [
            torch.stack([zeros, -nz, ny], -1),
            torch.stack([nz, zeros, -nx], -1),
            torch.stack([-ny, nx, zeros], -1),
        ],
        -2,
    )
    t = theta[..., None]
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device)
    nnt = n[..., :, None] * n[..., None, :]
    r = torch.cos(t) * eye + torch.sin(t) * k + (1.0 - torch.cos(t)) * nnt
    return torch.where(t > 1e-8, r, eye + t * k)


def pca_to_axisang(pose_pca: torch.Tensor, params: dict, ncomps: int = 45,
                   add_mean: bool = True) -> torch.Tensor:
    """manopth-style PCA pose -> 45-dim axis-angle."""
    full = pose_pca @ params["hands_components"][:ncomps]
    if add_mean:
        full = full + params["hands_mean"]
    return full


def mano_forward(params: dict, global_orient: torch.Tensor, hand_pose: torch.Tensor,
                 betas: torch.Tensor, transl: torch.Tensor | None = None,
                 flat_hand_mean: bool = True) -> dict:
    """Batched MANO LBS.

    global_orient (B, 3), hand_pose (B, 45) axis-angle, betas (B, 10),
    optional transl (B, 3). Returns 'vertices' (B, 778, 3) and 'joints'
    (B, 21, 3): 16 skeleton joints then 5 fingertips.
    """
    if not flat_hand_mean:
        hand_pose = hand_pose + params["hands_mean"]
    b = global_orient.shape[0]
    full_pose = torch.cat([global_orient, hand_pose], dim=1).reshape(b, NUM_JOINTS, 3)

    v_shaped = params["v_template"] + torch.einsum("bl,vcl->bvc", betas, params["shapedirs"])
    joints = torch.einsum("jv,bvc->bjc", params["j_regressor"], v_shaped)

    rot_mats = rodrigues(full_pose)  # (B, 16, 3, 3)
    eye = torch.eye(3, dtype=rot_mats.dtype, device=rot_mats.device)
    pose_feature = (rot_mats[:, 1:] - eye).reshape(b, NUM_POSE * 3)
    v_posed = v_shaped + torch.einsum("bp,vcp->bvc", pose_feature, params["posedirs"])

    parents = MANO_PARENTS
    rel_t = [joints[:, 0]] + [joints[:, i] - joints[:, parents[i]] for i in range(1, NUM_JOINTS)]
    bottom = constant((0.0, 0.0, 0.0, 1.0), rot_mats.dtype, rot_mats.device).expand(b, 1, 4)
    transforms = []
    for i in range(NUM_JOINTS):
        local = torch.cat([torch.cat([rot_mats[:, i], rel_t[i][:, :, None]], dim=2), bottom], dim=1)
        transforms.append(local if i == 0 else transforms[parents[i]] @ local)
    a_global = torch.stack(transforms, dim=1)  # (B, 16, 4, 4)

    posed_joints = a_global[:, :, :3, 3]
    j_h = torch.cat([joints, torch.zeros_like(joints[..., :1])], -1)
    correction = torch.einsum("bjmn,bjn->bjm", a_global, j_h)
    a_skin = a_global.clone()
    a_skin[..., 3] = a_skin[..., 3] - correction

    t_verts = torch.einsum("vj,bjmn->bvmn", params["lbs_weights"], a_skin)
    v_h = torch.cat([v_posed, torch.ones_like(v_posed[..., :1])], -1)
    verts = torch.einsum("bvmn,bvn->bvm", t_verts, v_h)[..., :3]

    tips = verts[:, constant(FINGERTIP_VERT_IDS, torch.long, verts.device), :]
    joints21 = torch.cat([posed_joints, tips], dim=1)
    if transl is not None:
        verts = verts + transl[:, None, :]
        joints21 = joints21 + transl[:, None, :]
    return {"vertices": verts, "joints": joints21}
