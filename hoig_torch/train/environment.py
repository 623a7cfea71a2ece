"""Asset and configuration assembly: options -> (tables, MANO, configs)
(port of hoig_tpu/train/environment.py).

Bridges the argparse surface to the functional training core. Dataset
variants: HOv3 = camMat camera, armask, D 19 channels; DexYCB = fx/fy
camera, PCA-45 MANO, hand-segment channels appended, D 24 channels, no
masks.
"""

from __future__ import annotations

import os

import torch

from hoig_torch.geometry.conditioning import ConditioningConfig
from hoig_torch.geometry.mano import MANOModel
from hoig_torch.geometry.renderer import ObjectSpec, build_surface_tables
from hoig_torch.train.trainer import TrainConfig


def find_mano_pickle(path: str) -> str:
    """A MANO_RIGHT*.pkl under a smplx-style models directory, or the path
    itself when it is a file (the reference's --mano_model is
    assets/smplx/models/)."""
    if os.path.isfile(path):
        return path
    for root, _, files in os.walk(path):
        for f in files:
            if f.upper().startswith("MANO_RIGHT") and f.endswith(".pkl"):
                return os.path.join(root, f)
    raise FileNotFoundError(f"No MANO_RIGHT.pkl found under {path}")


def _maybe(path):
    return path if os.path.exists(path) else None


def dataset_objects(opt) -> list:
    """The object specs in the order MANORenderer.__init__ lists them
    (reference nmr.py:276-279: a sorted listdir of the object root), each
    with its texture where the PNG exists."""
    if opt.dataset_mode == "ycb":
        from hoig_torch.data.ycb_dataset import OBJNAMES

        root = getattr(opt, "obj_dir", os.path.join(opt.data_dir, "models"))
        return [ObjectSpec(name=n, obj_path=os.path.join(root, n, "textured_pre.obj"),
                           texture_path=_maybe(os.path.join(root, n, "texture_map_resize.png")))
                for n in OBJNAMES]
    from hoig_torch.data.hov3_dataset import OBJNAMES

    root = getattr(opt, "obj_dir", "assets/obj")
    names = sorted(os.listdir(root)) if os.path.isdir(root) else OBJNAMES
    return [ObjectSpec(name=n, obj_path=os.path.join(root, n, n + ".obj"),
                       texture_path=_maybe(os.path.join(root, n, "texture_map.png")))
            for n in names]


def conditioning_config(opt) -> ConditioningConfig:
    is_ycb = opt.dataset_mode == "ycb"
    return ConditioningConfig(
        image_size=opt.image_size,
        camera_model="fxfy" if is_ycb else "matrix",
        mano_pca_comps=45 if is_ycb else 0,
        mano_flat_hand_mean=not is_ycb,
        bg_both=getattr(opt, "bg_both", False),
    )


def build_environment(opt, device="cuda") -> dict:
    """-> dict(tables_np, tables, mano, mano_params, ccfg, is_ycb), the
    tables and MANO parameters as tensors on `device`. Synthetic runs take
    the fixture environment; real-data runs check their assets first."""
    if getattr(opt, "synthetic_data", False) or opt.dataset_mode == "synthetic":
        from hoig_torch.data.synthetic import host_environment

        tables_np, mano, _ = host_environment(getattr(opt, "synthetic_num_objects", 2),
                                              opt.image_size, 0)
    else:
        from hoig_torch.utils.preflight import preflight_assets

        preflight_assets(opt)
        mano = MANOModel.from_pickle(find_mano_pickle(opt.mano_model))
        uv = opt.uv_mapping[0] if isinstance(opt.uv_mapping, list) else opt.uv_mapping
        tables_np = build_surface_tables(uv, dataset_objects(opt),
                                         getattr(opt, "sem_hand", "assets/semantics_hand.pkl"),
                                         map_name=opt.map_name, image_size=opt.image_size)
    return dict(tables_np=tables_np, tables=tables_np.as_torch(device), mano=mano,
                mano_params=mano.as_torch(device), ccfg=conditioning_config(opt),
                is_ycb=opt.dataset_mode == "ycb")


def resolve_corner_engine(engine: str, bf16: bool) -> str:
    """'auto' -> the attention corner engine for the precision mode: 'shift'
    under bf16, 'gather' under f32 (the JAX package's picks); explicit
    values pass through."""
    if engine == "auto":
        return "shift" if bf16 else "gather"
    return engine


def train_config_from_opt(opt) -> TrainConfig:
    is_ycb = opt.dataset_mode == "ycb"
    # per-variant widths (HOIG_HOv3/models/trainer.py:260-267,
    # HOIG_DexYCB/models/trainer.py:263-270)
    if is_ycb:
        dims = dict(bg_dim=13, img_dim=3, obj_dim=3, img_cond_dim=9, obj_cond_dim=12,
                    d_input_nc=24, use_armask=False)
    else:
        dims = dict(bg_dim=8, img_dim=3, obj_dim=3, img_cond_dim=3, obj_cond_dim=12,
                    d_input_nc=19, use_armask=True)
    if not getattr(opt, "use_spade", True):
        dims.update(img_dim=12, obj_dim=12)
    bf16 = getattr(opt, "bf16", False)
    # full remat in f32; under bf16 the bottleneck and the attention
    # activations are kept unless --remat_bottleneck asks for full remat
    full_remat = getattr(opt, "remat_bottleneck", False) or not bf16
    return TrainConfig(
        gen_name=opt.gen_name,
        use_spade=getattr(opt, "use_spade", True),
        repeat_num=opt.repeat_num,
        conv_dim=getattr(opt, "conv_dim", 64),
        remat=not getattr(opt, "no_remat", False),
        remat_bottleneck=full_remat,
        remat_attn=full_remat,
        corner_engine=resolve_corner_engine(getattr(opt, "corner_engine", "auto"), bf16),
        image_size=opt.image_size,
        d_norm_type=opt.norm_type,
        lr_G=getattr(opt, "lr_G", 2e-4),
        lr_D=getattr(opt, "lr_D", 2e-4),
        final_lr=getattr(opt, "final_lr", 2e-6),
        adam_b1=getattr(opt, "G_adam_b1", 0.5),
        adam_b2=getattr(opt, "G_adam_b2", 0.999),
        nepochs_decay=getattr(opt, "nepochs_decay", 20),
        lambda_D_prob=getattr(opt, "lambda_D_prob", 1.0),
        lambda_rec=getattr(opt, "lambda_rec", 10.0),
        lambda_tsf=getattr(opt, "lambda_tsf", 10.0),
        lambda_mask=getattr(opt, "lambda_mask", 0.1),
        lambda_mask_smooth=getattr(opt, "lambda_mask_smooth", 1e-5),
        use_vgg=getattr(opt, "use_vgg", False),
        mask_bce=getattr(opt, "mask_bce", False),
        train_G_every_n_iterations=getattr(opt, "train_G_every_n_iterations", 1),
        compute_dtype=torch.bfloat16 if bf16 else torch.float32,
        **dims,
    )
