"""Generic renderer objects: the neural renderer's `Mesh` and `Renderer`.

Port of hoig_tpu/geometry/neural_renderer_api.py
(thirdparty/neural_renderer/neural_renderer/{renderer,mesh}.py), over the
port's ops: the hard maps through `rasterize_fim_wim_auto` (the B2 and B3
kernels on CUDA tensors), soft coverage, and the exact-gradient autograd
Functions of ops/rasterizer_grad.py. Tensors stay on the device they come
on; the classes hold configuration only.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from hoig_torch.geometry.obj_io import load_obj_with_textures, save_obj_textured
from hoig_torch.geometry.projection import look_at as look_at_fn
from hoig_torch.geometry.projection import vertices_to_faces
from hoig_torch.ops._cuda import resolve_device
from hoig_torch.ops.grid_sample import avg_pool
from hoig_torch.ops.rasterizer import rasterize_depth, rasterize_silhouette, soft_silhouette
from hoig_torch.ops.rasterizer_cuda import rasterize_fim_wim_auto
from hoig_torch.ops.rasterizer_grad import (
    DEFAULT_EPS,
    rasterize_depth_exact,
    rasterize_silhouette_exact,
    render_rgb_exact,
)
from hoig_torch.ops.texture import lighting as apply_lighting
from hoig_torch.ops.texture import sample_textures_trilinear


@dataclasses.dataclass
class Mesh:
    """Vertices (V, 3) or (B, V, 3), faces (F, 3) int, optional textures
    (F, T, T, T, 3) or (B, F, T, T, T, 3)."""

    vertices: torch.Tensor
    faces: torch.Tensor
    textures: torch.Tensor | None = None

    @classmethod
    def from_obj(cls, path: str, load_texture: bool = False, tex_size: int = 3,
                 device="cuda"):
        """On the card unless the caller passes device="cpu"."""
        info, textures = load_obj_with_textures(path, tex_size)
        device = resolve_device(device)
        return cls(vertices=torch.as_tensor(info["vertices"], device=device),
                   faces=torch.as_tensor(info["faces"], device=device),
                   textures=torch.as_tensor(textures, device=device) if load_texture else None)

    def save_obj(self, path: str, texture_size_out: int = 16):
        v = self.vertices if self.vertices.dim() == 2 else self.vertices[0]
        save_obj_textured(path, v.detach().cpu().numpy(), self.faces.cpu().numpy(),
                          None if self.textures is None else
                          self.textures.detach().cpu().numpy(), texture_size_out)

    def batched(self):
        v = self.vertices if self.vertices.dim() == 3 else self.vertices[None]
        t = None
        if self.textures is not None:
            t = self.textures if self.textures.dim() == 6 else self.textures[None]
        return v, self.faces, t


@dataclasses.dataclass
class Renderer:
    """Camera (look_at from `eye`), lighting and rasterization settings."""

    image_size: int = 256
    anti_aliasing: bool = True
    background_color: tuple = (0.0, 0.0, 0.0)
    viewing_angle: float = 30.0
    eye: tuple | None = None
    camera_direction: tuple = (0.0, 0.0, 1.0)
    near: float = 0.1
    far: float = 100.0
    light_intensity_ambient: float = 0.5
    light_intensity_directional: float = 0.5
    light_color_ambient: tuple = (1.0, 1.0, 1.0)
    light_color_directional: tuple = (1.0, 1.0, 1.0)
    light_direction: tuple = (0.0, 1.0, 0.0)

    def _eye(self):
        if self.eye is not None:
            return self.eye
        return (0.0, 0.0, -(1.0 / np.tan(np.radians(self.viewing_angle)) + 1.0))

    def _view_faces(self, vertices, faces):
        return vertices_to_faces(look_at_fn(vertices, self._eye()), faces)

    def _raster_size(self) -> int:
        return self.image_size * (2 if self.anti_aliasing else 1)

    def _lit(self, vertices, faces, textures):
        return apply_lighting(vertices_to_faces(vertices, faces), textures,
                              self.light_intensity_ambient, self.light_intensity_directional,
                              self.light_color_ambient, self.light_color_directional,
                              self.light_direction)

    def render_silhouettes(self, vertices, faces, soft: bool = False, exact_grad: bool = False):
        """Coverage (B, S, S). Three gradient modes: the hard map (no vertex
        gradient; HOGAN's use), `soft` (sigmoid coverage, autograd), and
        `exact_grad` (the hard map with the reference's backward_pixel_map)."""
        fv = self._view_faces(vertices, faces)
        if soft:
            return soft_silhouette(fv, image_size=self.image_size)
        s = self._raster_size()
        if exact_grad:
            valid = torch.ones(fv.shape[:2], dtype=torch.float32, device=fv.device)
            sil = rasterize_silhouette_exact(fv, valid, s, self.near, self.far)
        else:
            sil = rasterize_silhouette(fv, image_size=s, near=self.near, far=self.far)
        if self.anti_aliasing:
            sil = avg_pool(sil[:, None], 2)[:, 0]
        return sil

    def render_depth(self, vertices, faces, exact_grad: bool = False):
        """Depth map (B, S, S) at image_size (no anti-aliasing), `far` on the
        background; `exact_grad` gives it the reference's backward_depth_map."""
        fv = self._view_faces(vertices, faces)
        if exact_grad:
            valid = torch.ones(fv.shape[:2], dtype=torch.float32, device=fv.device)
            return rasterize_depth_exact(fv, valid, self.image_size, self.near, self.far)
        return rasterize_depth(fv, image_size=self.image_size, near=self.near, far=self.far)

    def _fim(self, fv):
        fim, _ = rasterize_fim_wim_auto(fv, image_size=self.image_size, near=self.near,
                                        far=self.far)
        return fim

    def render(self, vertices, faces, textures, get_fim: bool = False, exact_grad: bool = False):
        """RGB render (B, 3, S, S): lighting, rasterization (2x with
        anti-aliasing), texture sampling. `exact_grad` takes the reference
        RasterizeFunction's backward (textures through the sampling weights,
        vertices through the edge-walking pixel map). With `get_fim` also the
        face-index map at image_size."""
        if not exact_grad:
            return self._render_plain(vertices, faces, textures, get_fim)
        lit = self._lit(vertices, faces, textures)
        fv = self._view_faces(vertices, faces)
        valid = torch.ones(fv.shape[:2], dtype=torch.float32, device=fv.device)
        rgb = render_rgb_exact(fv, lit, valid, self._raster_size(), self.near, self.far, 128,
                               DEFAULT_EPS, self.background_color).permute(0, 3, 1, 2)
        if self.anti_aliasing:
            rgb = avg_pool(rgb, 2)
        return (rgb, self._fim(fv)) if get_fim else rgb

    def _render_plain(self, vertices, faces, textures, get_fim: bool = False):
        """RGB render with autograd through the sampling (no vertex gradient
        through the hard maps)."""
        lit = self._lit(vertices, faces, textures)
        fv = self._view_faces(vertices, faces)
        fim, wim = rasterize_fim_wim_auto(fv, image_size=self._raster_size(), near=self.near,
                                          far=self.far)
        rgb = sample_textures_trilinear(lit, fim, wim, self.background_color).permute(0, 3, 1, 2)
        if self.anti_aliasing:
            rgb = avg_pool(rgb, 2)
        return (rgb, self._fim(fv)) if get_fim else rgb

    def render_mesh(self, mesh: Mesh, mode: str = "rgb"):
        """Render a Mesh: 'rgb' (white textures where it has none),
        'silhouettes' or 'depth'."""
        v, f, t = mesh.batched()
        if mode == "silhouettes":
            return self.render_silhouettes(v, f)
        if mode == "depth":
            return self.render_depth(v, f)
        if t is None:
            t = torch.ones((v.shape[0], f.shape[0], 3, 3, 3, 3), dtype=torch.float32,
                           device=v.device)
        return self.render(v, f, t)
