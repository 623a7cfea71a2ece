"""The parts of hoig_tpu/train/trainer.py on the serving path: the config,
the conditioning -> generator input split and the composite."""

from __future__ import annotations

import dataclasses

import torch

from hoig_torch.models import NetworksFactory


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Model configuration (defaults = the HOv3 spade config of the reference)."""

    gen_name: str = "generator_spade_attn"
    use_spade: bool = True
    repeat_num: int = 6
    conv_dim: int = 64
    bg_dim: int = 8
    img_dim: int = 3
    obj_dim: int = 3
    img_cond_dim: int = 3
    obj_cond_dim: int = 12
    use_armask: bool = True
    corner_engine: str = "gather"
    compute_dtype: torch.dtype = torch.float32


def build_generator(cfg: TrainConfig, device="cuda", seed: int = 0):
    """The configured generator with seeded random weights on `device`."""
    return NetworksFactory.get_by_name(
        cfg.gen_name,
        bg_dim=cfg.bg_dim,
        img_dim=cfg.img_dim,
        obj_dim=cfg.obj_dim,
        img_cond_dim=cfg.img_cond_dim if cfg.use_spade else 0,
        obj_cond_dim=cfg.obj_cond_dim if cfg.use_spade else 0,
        conv_dim=cfg.conv_dim,
        repeat_num=cfg.repeat_num,
        corner_engine=cfg.corner_engine,
        compute_dtype=cfg.compute_dtype,
        device=device,
        seed=seed,
    )


def _nhwc(x):
    return None if x is None else x.permute(0, 2, 3, 1)


def generator_kwargs(flow: dict, armask_src, armask_tsf, use_spade: bool) -> dict:
    """Conditioning outputs (NCHW) -> Generator NHWC kwargs."""
    if use_spade:
        return dict(
            bg_inputs=_nhwc(flow["input_G_src_bg"]),
            src_obj_inputs=_nhwc(flow["input_G_src_obj"][:, :3]),
            tsf_obj_inputs=_nhwc(flow["input_G_tsf_obj"][:, :3]),
            src_hand_inputs=_nhwc(flow["input_G_src_hand"][:, :3]),
            tsf_hand_inputs=_nhwc(flow["input_G_tsf_hand"][:, :3]),
            T=flow["T"],
            src_obj_conds=_nhwc(flow["input_G_src_obj"][:, 3:]),
            src_hand_conds=_nhwc(flow["input_G_src_hand"][:, 3:]),
            tsf_obj_conds=_nhwc(flow["input_G_tsf_obj"][:, 3:]),
            tsf_hand_conds=_nhwc(flow["input_G_tsf_hand"][:, 3:]),
            src_armask=_nhwc(armask_src),
            tsf_armask=_nhwc(armask_tsf),
        )
    return dict(
        bg_inputs=_nhwc(flow["input_G_src_bg"]),
        src_obj_inputs=_nhwc(flow["input_G_src_obj"]),
        tsf_obj_inputs=_nhwc(flow["input_G_tsf_obj"]),
        src_hand_inputs=_nhwc(flow["input_G_src_hand"]),
        tsf_hand_inputs=_nhwc(flow["input_G_tsf_hand"]),
        T=flow["T"],
        src_armask=_nhwc(armask_src),
        tsf_armask=_nhwc(armask_tsf),
    )


def composite(outs):
    """fake = mask_bg * bg + (1 - mask_bg) * (obj * mask_hand + hand * (1 - mask_hand));
    returns (fake_src, fake_tsf, src_mbg, src_mh, tsf_mbg, tsf_mh)."""
    (src_bg, tsf_bg, src_obj, src_hand, src_mbg, src_mh,
     tsf_obj, tsf_hand, tsf_mbg, tsf_mh) = outs
    fake_src = src_mbg * src_bg + (1 - src_mbg) * (src_obj * src_mh + src_hand * (1 - src_mh))
    fake_tsf = tsf_mbg * tsf_bg + (1 - tsf_mbg) * (tsf_obj * tsf_mh + tsf_hand * (1 - tsf_mh))
    return fake_src, fake_tsf, src_mbg, src_mh, tsf_mbg, tsf_mh
