"""UV-image utilities (port of hoig_tpu/geometry/uv_image.py; reference
utils/mesh.py:440-620): condition-map display images, per-face UV samplers,
and the inverse texture map that fits a UV image to per-face textures.

`compute_uv_image` is a `torch.optim.Adam` loop with optax.adam's settings
(lr, b1 0.9, b2 0.999, eps 1e-8). The two apply the bias corrections in
another order, so over many steps they part by rounding; on CUDA the grid
sample's gradient is a scatter-add with float atomics, whose order is not
fixed.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from hoig_torch.geometry.mesh import load_obj
from hoig_torch.ops._cuda import resolve_device
from hoig_torch.ops.grid_sample import grid_sample


def cvt_fim_enc(fim_enc: np.ndarray, map_name: str) -> np.ndarray:
    """Condition map (H, W, C) -> display image (mesh.py:440-489)."""
    h, w, _ = fim_enc.shape
    if map_name == "uv":
        img = np.ones((h, w, 3), np.float32)
        img[:, :, 0:2] = fim_enc[:, :, 0:2]
        return img.transpose(2, 0, 1)
    if map_name in ("seg", "ids"):
        return fim_enc[:, :, 0].astype(np.float32)
    if map_name == "uv_seg":
        return fim_enc.astype(np.float32).transpose(2, 0, 1)
    if map_name == "par":
        img = fim_enc.argmax(axis=-1).astype(np.float32)
        return img / max(img.max(), 1e-8)
    if map_name == "binary":
        weights = 1 << np.arange(fim_enc.shape[-1])[::-1]
        img = (fim_enc.astype(np.int64) * weights).sum(-1).astype(np.float32)
        return img / max(img.max(), 1e-8)
    raise ValueError(map_name)


def create_uvsampler(uv_mapping_path: str, tex_size: int = 2) -> np.ndarray:
    """Per-face UV sample points (mesh.py:492-530): (F, T*T, 2) in [-1, 1]."""
    alpha = np.arange(tex_size, dtype=np.float32) / (tex_size - 1)
    coords = np.stack(list(itertools.product(alpha, alpha)))  # (T*T, 2)
    info = load_obj(uv_mapping_path)
    vts = info["vts"].copy()
    vts[:, 1] = 1.0 - vts[:, 1]
    f2vts = vts[info["faces_vts"]]  # (F, 3, 2)
    v2 = f2vts[:, 2]
    basis = np.stack([f2vts[:, 0] - v2, f2vts[:, 1] - v2], axis=-1)  # (F, 2, 2)
    samples = basis @ coords.T + v2[..., None]  # (F, 2, T*T)
    samples = np.clip(samples, 0.0, 1.0).transpose(0, 2, 1)
    return (samples * 2.0 - 1.0).astype(np.float32)


def compute_uv_image(uv: np.ndarray, texture: np.ndarray, uv_size: int = 224, steps: int = 2000,
                     lr: float = 1e-2, device="cuda") -> np.ndarray:
    """Fit a (3, uv_size, uv_size) image in [-1, 1] whose bilinear samples at
    `uv` match `texture` (mesh.py:570-620): Adam on a weight w from -1,
    image tanh(w), loss the mean squared error.

    uv (F, T, T, 2) in [-1, 1]; texture (F, T, T, 3). Returns (3, H, W)."""
    dev = resolve_device(device)
    f, t = uv.shape[:2]
    grid = torch.as_tensor(np.asarray(uv, np.float32).reshape(1, f, t * t, 2), device=dev)
    target = torch.as_tensor(np.asarray(texture, np.float32).reshape(1, f, t, t, 3), device=dev)
    weight = torch.full((1, 3, uv_size, uv_size), -1.0, device=dev, requires_grad=True)
    opt = torch.optim.Adam([weight], lr=lr, betas=(0.9, 0.999), eps=1e-8)
    for _ in range(steps):
        tex = grid_sample(torch.tanh(weight), grid)  # (1, 3, F, T*T)
        tex = tex.reshape(1, 3, f, t, t).permute(0, 2, 3, 4, 1)
        loss = torch.mean((tex - target) ** 2)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    with torch.no_grad():
        return torch.tanh(weight)[0].cpu().numpy()
