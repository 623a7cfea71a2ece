"""Conditioning front end: batched HandRecoveryFlow.

Port of hoig_tpu/geometry/conditioning.py (reference models/trainer.py:14-185):
MANO LBS -> merged hand + object vertices -> one rasterization of the src
and ref halves stacked as a 2B batch, whose finish gather also fetches every
fim-indexed attribute -> condition / semantic maps, barycentric flow and
texture backward warp -> generator input assembly. Tensors are NCHW except
the flow T (B, S, S, 2).
"""

from __future__ import annotations

import dataclasses

import torch

from hoig_torch.geometry import renderer as rend
from hoig_torch.geometry.mano import mano_forward, pca_to_axisang
from hoig_torch.geometry.projection import (
    orthographic_proj_withz_fxfy,
    orthographic_proj_withz_idrot,
    to_view_space,
    vertices_to_faces,
)
from hoig_torch.ops.grid_sample import grid_sample_packed
from hoig_torch.ops.morph import morph
from hoig_torch.ops.rasterizer_cuda import rasterize_fim_wim_auto

NUM_HAND_FACES = rend.NUM_HAND_FACES


@dataclasses.dataclass(frozen=True)
class ConditioningConfig:
    """camera_model: 'matrix' (HOv3 camMat + crop) or 'fxfy' (DexYCB);
    mano_pca_comps: 0 = axis-angle, > 0 = PCA front end; mano_scale: output
    vertex scale (DexYCB works in mm); num_seg_channels: one-hot semantic
    channels (ids >= 16 drop out, as in the reference)."""

    image_size: int = 256
    camera_model: str = "matrix"
    mano_pca_comps: int = 0
    mano_flat_hand_mean: bool = True
    mano_scale: float = 1.0
    num_seg_channels: int = 15
    bg_both: bool = False


def get_details(mano_params: dict, theta: dict, cfg: ConditioningConfig) -> dict:
    """theta: 'cam' (B, 9|4), 'trans' (B, 2, 3), 'pose' (B, 3+P), 'shape'
    (B, 10), 'handtrans' (B, 3) (or folded into pose[:, 48:51]),
    'vertices_obj' (B, Vobj, 3), 'obj_id' (B,). Returns 'cam', 'verts'
    (B, 778+Vobj, 3) and 'obj_id'."""
    b = theta["cam"].shape[0]
    pose = theta["pose"]
    handtrans = theta.get("handtrans")
    if handtrans is None:
        handtrans = pose[:, 48:51]
        pose = pose[:, :48]
    root, hand_pose = pose[:, :3], pose[:, 3:]
    if cfg.mano_pca_comps > 0:
        hand_pose = pca_to_axisang(hand_pose, mano_params, ncomps=cfg.mano_pca_comps)
        out = mano_forward(mano_params, root, hand_pose, theta["shape"], flat_hand_mean=True)
        verts_hand = out["vertices"] * cfg.mano_scale + handtrans[:, None, :]
    else:
        out = mano_forward(mano_params, root, hand_pose, theta["shape"], transl=handtrans,
                           flat_hand_mean=cfg.mano_flat_hand_mean)
        verts_hand = out["vertices"]
    verts = torch.cat([verts_hand, theta["vertices_obj"]], dim=1)
    cam = torch.cat([theta["cam"].reshape(b, -1), theta["trans"].reshape(b, -1)], dim=1)
    return {"cam": cam, "verts": verts, "obj_id": theta["obj_id"]}


def _hand_mask(fim: torch.Tensor) -> torch.Tensor:
    """Eroded NOT-hand mask: 1 = not confidently hand."""
    is_hand = (fim >= 0) & (fim < NUM_HAND_FACES)
    return morph(1.0 - is_hand[:, None].float(), ks=3, mode="erode")


def _split_cond(cond: torch.Tensor):
    """Hand / object separation of the (B, 3, S, S) uv_seg map: hand uv lies
    in [0, 1], object uv is shifted by >= 1.5; channel 2 is 1 on background."""
    hand_mask = (cond[:, :1] < 1.5).to(cond.dtype)
    cond_hand = torch.cat([hand_mask * cond[:, :2], cond[:, 2:] + 1.0 - hand_mask], dim=1)
    obj_mask = (cond[:, :1] > 1.5).to(cond.dtype)
    cond_obj = torch.cat([obj_mask * cond[:, :2], cond[:, 2:] + 1.0 - obj_mask], dim=1)
    return cond_hand, cond_obj


def _seg_onehot(seg_ids: torch.Tensor, num: int) -> torch.Tensor:
    """(B, 1, S, S) float ids -> (B, num, S, S) one-hot over ids 1..num."""
    return torch.cat([(seg_ids == i).float() for i in range(1, num + 1)], dim=1)


def hand_recovery_flow(tables: dict, mano_params: dict, src_img: torch.Tensor,
                       ref_img: torch.Tensor, src_theta: dict, ref_theta: dict,
                       cfg: ConditioningConfig) -> dict:
    """Full conditioning pass -> generator inputs and masks (NCHW), T (B,S,S,2)."""
    both_theta = {k: torch.cat([src_theta[k], ref_theta[k]], dim=0) for k in src_theta}
    both_info = get_details(mano_params, both_theta, cfg)
    # the SOURCE object identity keys every per-object table for both halves
    obj_ids = both_info["obj_id"][: src_img.shape[0]].long()
    obj_ids2 = torch.cat([obj_ids, obj_ids], dim=0)

    proj_fn = (orthographic_proj_withz_idrot if cfg.camera_model == "matrix"
               else orthographic_proj_withz_fxfy)
    proj = proj_fn(both_info["verts"], both_info["cam"], image_size=cfg.image_size)
    view = to_view_space(proj)
    faces2 = tables["faces"][obj_ids2]
    valid2 = tables["face_valid"][obj_ids2]
    face_verts = vertices_to_faces(view, faces2)
    both_f2pts = vertices_to_faces(proj, faces2)[..., 0:2]
    src_f2pts = both_f2pts[: src_img.shape[0]]

    # both halves warp the SRC face corners; the src half's copy is unused
    attrs = rend.build_attr_table(tables, obj_ids2,
                                  extra_f2pts=torch.cat([src_f2pts, src_f2pts], dim=0))
    both_fim, both_wim, rows = rasterize_fim_wim_auto(
        face_verts, valid2, image_size=cfg.image_size, near=0.1, far=25.0, attrs=attrs,
    )
    src_fim, ref_fim = both_fim.chunk(2, dim=0)
    cond2, sem2, t_uv2, t_extra2 = rend.split_encoded_rows(rows, both_fim, both_wim)
    src_cond, ref_cond = cond2.chunk(2, dim=0)
    src_sem, ref_sem = sem2.chunk(2, dim=0)
    t_src, t_ref = t_uv2.chunk(2, dim=0)
    t_flow = t_extra2.chunk(2, dim=0)[1]
    src_seg = _seg_onehot(src_sem, cfg.num_seg_channels)
    ref_seg = _seg_onehot(ref_sem, cfg.num_seg_channels)
    src_mask_hand = _hand_mask(src_fim)
    ref_mask_hand = _hand_mask(ref_fim)

    hand_region = ref_mask_hand[:, 0][..., None] == 0
    t_hand = torch.where(hand_region, t_flow, -2.0)

    input_texture = rend.get_texture_backward_warp(tables, src_img, src_f2pts, src_fim, obj_ids)
    render_img_ref = grid_sample_packed(input_texture, t_ref, align_corners=True)
    render_img_src = grid_sample_packed(input_texture, t_src, align_corners=True)

    src_mask_bg = morph(src_cond[:, -1:], ks=3, mode="erode")
    ref_mask_bg = morph(ref_cond[:, -1:], ks=3, mode="erode")
    src_cond_hand, src_cond_obj = _split_cond(src_cond)
    ref_cond_hand, ref_cond_obj = _split_cond(ref_cond)

    input_g_src_obj = torch.cat(
        [render_img_src * (src_mask_hand - src_mask_bg), src_cond_obj, src_seg[:, 6:]], dim=1)
    input_g_tsf_obj = torch.cat(
        [render_img_ref * (ref_mask_hand - ref_mask_bg), ref_cond_obj, ref_seg[:, 6:]], dim=1)
    hand_extra_src = [src_seg[:, :6]] if cfg.camera_model == "fxfy" else []
    hand_extra_ref = [ref_seg[:, :6]] if cfg.camera_model == "fxfy" else []
    input_g_src_hand = torch.cat(
        [src_img * (1.0 - src_mask_hand), src_cond_hand] + hand_extra_src, dim=1)
    input_g_tsf_hand = torch.cat(
        [render_img_ref * (1.0 - ref_mask_hand), ref_cond_hand] + hand_extra_ref, dim=1)

    src_bg_mask = morph(src_cond[:, -1:], ks=15, mode="erode")
    input_g_src_bg = torch.cat([src_img * src_bg_mask, src_bg_mask], dim=1)
    input_g_tsf_bg = None
    if cfg.bg_both:
        ref_bg_mask = morph(ref_cond[:, -1:], ks=15, mode="erode")
        input_g_tsf_bg = torch.cat([ref_img * ref_bg_mask, ref_bg_mask], dim=1)

    return {
        "input_G_src_bg": input_g_src_bg,
        "input_G_tsf_bg": input_g_tsf_bg,
        "input_G_src_obj": input_g_src_obj,
        "input_G_tsf_obj": input_g_tsf_obj,
        "input_G_src_hand": input_g_src_hand,
        "input_G_tsf_hand": input_g_tsf_hand,
        "T": t_hand,
        "src_crop_mask_bg": src_mask_bg,
        "tsf_crop_mask_bg": ref_mask_bg,
        "src_crop_mask_hand": src_mask_hand,
        "tsf_crop_mask_hand": ref_mask_hand,
    }
