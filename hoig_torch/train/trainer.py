"""GAN trainer (port of hoig_tpu/train/trainer.py).

LSGAN objective with target -1 for D-fake, L1 source reconstruction, VGG
perceptual transfer loss, BCE / MSE mask losses against the conditioning
masks, TV mask smoothness, one Adam(0.5, 0.999) per network, G updated every
step and D only where the caller says so, linear LR decay to final_lr.

In PyTorch's idiom: `TrainState` owns the two modules and their optimizers
and `train_step` updates them in place (the JAX step returned a new state).
One step runs the conditioning under no-grad, the generator forward, the G
loss graph and G's Adam update, then the D loss on the real image and the
detached fake with D's parameters from before the step, and D's Adam update
where `d_trainable` says so. The G loss is differentiated with respect to
G's parameters only (D takes part in it but gets no gradient from it). The
metrics are device scalars; the step itself never waits for the device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from hoig_torch.geometry.conditioning import ConditioningConfig, hand_recovery_flow
from hoig_torch.models import NetworksFactory
from hoig_torch.models.vgg import vgg_perceptual_loss
from hoig_torch.train.losses import bce_loss, l1_loss, lsgan_loss, mse_loss, tv_smooth_loss, wmean
from hoig_torch.utils.profiling import annotate


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Hyperparameters (defaults = the HOv3 spade config of the reference)."""

    gen_name: str = "generator_spade_attn"
    use_spade: bool = True
    repeat_num: int = 6
    conv_dim: int = 64
    image_size: int = 256
    bg_dim: int = 8
    img_dim: int = 3
    obj_dim: int = 3
    img_cond_dim: int = 3
    obj_cond_dim: int = 12
    d_input_nc: int = 19
    d_norm_type: str = "instance"
    use_armask: bool = True
    # optimization
    lr_G: float = 2e-4
    lr_D: float = 2e-4
    final_lr: float = 2e-6
    adam_b1: float = 0.5
    adam_b2: float = 0.999
    nepochs_decay: int = 15
    lambda_D_prob: float = 1.0
    lambda_rec: float = 10.0
    lambda_tsf: float = 10.0
    lambda_mask: float = 1.0
    lambda_mask_smooth: float = 1.0
    use_vgg: bool = True
    mask_bce: bool = True
    train_G_every_n_iterations: int = 1
    # activation rematerialization (models/generator.py): conv blocks; the
    # bottleneck's residual blocks as well; the attention layers as well
    remat: bool = True
    remat_bottleneck: bool = True
    remat_attn: bool = True
    corner_engine: str = "gather"
    compute_dtype: torch.dtype = torch.float32


@dataclasses.dataclass
class TrainState:
    """The networks, their optimizers and the schedule; updated in place."""

    g: torch.nn.Module
    d: torch.nn.Module
    opt_g: torch.optim.Optimizer
    opt_d: torch.optim.Optimizer
    step: int
    lr_g: float
    lr_d: float


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
        remat=cfg.remat,
        remat_bottleneck=cfg.remat_bottleneck,
        remat_attn=cfg.remat_attn,
        corner_engine=cfg.corner_engine,
        compute_dtype=cfg.compute_dtype,
        device=device,
        seed=seed,
    )


def build_networks(cfg: TrainConfig, device="cuda", seed: int = 0):
    """(generator, PatchGAN-4 discriminator) with weights from `seed` and
    `seed + 1`, on `device` (CUDA unless the caller names the CPU)."""
    d = NetworksFactory.get_by_name(
        "discriminator_patch_gan",
        input_nc=cfg.d_input_nc,
        norm_type=cfg.d_norm_type,
        ndf=64,
        n_layers=4,
        use_sigmoid=False,
        compute_dtype=cfg.compute_dtype,
        device=device,
        seed=seed + 1,
    )
    return build_generator(cfg, device, seed), d


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


def _armasks(batch: dict, tcfg: TrainConfig):
    if not tcfg.use_armask:
        return None, None
    return batch.get("maskA"), batch.get("maskB")


def _d_cond(flow: dict, armask_tsf) -> torch.Tensor:
    """D conditioning channels: tsf obj cond ++ tsf hand cond ++ armask, NHWC."""
    parts = [_nhwc(flow["input_G_tsf_obj"][:, 3:]), _nhwc(flow["input_G_tsf_hand"][:, 3:])]
    if armask_tsf is not None:
        parts.append(_nhwc(armask_tsf))
    return torch.cat(parts, dim=-1)


def _forward_and_g_losses(g_model, d_model, vgg_loss, tcfg: TrainConfig, flow, batch, valid=None):
    """Generator forward and the full G-side loss graph: ONE implementation
    shared by the train step and the eval metrics, so that the validation
    scalars cannot drift from the trained objective.

    vgg_loss: callable (x, y, valid) -> scalar. valid: optional per-sample
    weights (B,), 0 for pad-replica samples on the eval path; training
    passes None.

    Returns (fakes, total, parts, d_fake_map) with fakes = (fake_src,
    fake_tsf, src_mbg, src_mh, tsf_mbg, tsf_mh)."""
    mask_crt = bce_loss if tcfg.mask_bce else mse_loss
    armask_src, armask_tsf = _armasks(batch, tcfg)
    with annotate("generator"):
        outs = g_model(**generator_kwargs(flow, armask_src, armask_tsf, tcfg.use_spade))
        # composite and losses always in f32, whatever the conv compute dtype
        fakes = composite(tuple(o.float() for o in outs))
    fake_src, fake_tsf, src_mbg, src_mh, tsf_mbg, tsf_mh = fakes

    with annotate("g_losses"):
        real_src = _nhwc(batch["imageA"])
        real_tsf = _nhwc(batch["imageB"])
        d_fake = d_model(torch.cat([fake_tsf, _d_cond(flow, armask_tsf)], dim=-1))

        loss_adv = lsgan_loss(d_fake, 0.0, w=valid) * tcfg.lambda_D_prob
        loss_rec = l1_loss(fake_src, real_src, w=valid) * tcfg.lambda_rec
        if tcfg.use_vgg:
            loss_tsf = vgg_loss(fake_tsf, real_tsf, valid) * tcfg.lambda_tsf
        else:
            loss_tsf = l1_loss(fake_tsf, real_tsf, w=valid) * tcfg.lambda_tsf

        masks_bg = torch.cat([src_mbg, tsf_mbg], dim=0)
        masks_hand = torch.cat([src_mh, tsf_mh], dim=0)
        tgt_bg = torch.cat([_nhwc(flow["src_crop_mask_bg"]), _nhwc(flow["tsf_crop_mask_bg"])],
                           dim=0)
        tgt_hand = torch.cat([_nhwc(flow["src_crop_mask_hand"]),
                              _nhwc(flow["tsf_crop_mask_hand"])], dim=0)
        # src / tsf mask maps are stacked along the batch: tile the weights to match
        valid2 = None if valid is None else torch.cat([valid, valid])
        loss_mask = (mask_crt(masks_bg, tgt_bg.detach(), w=valid2)
                     + mask_crt(masks_hand, tgt_hand.detach(), w=valid2)) * tcfg.lambda_mask
        loss_mask_smooth = (tv_smooth_loss(masks_bg, w=valid2)
                            + tv_smooth_loss(masks_hand, w=valid2)) * tcfg.lambda_mask_smooth

        total = loss_adv + loss_rec + loss_tsf + loss_mask + loss_mask_smooth
    parts = {"g_adv": loss_adv, "g_rec": loss_rec, "g_tsf": loss_tsf, "g_mask": loss_mask,
             "g_mask_smooth": loss_mask_smooth}
    return fakes, total, parts, d_fake


def _train_vgg_loss(vgg_model, tcfg: TrainConfig) -> Callable:
    """The train-time VGG loss: its activations are rematerialized together
    with the generator's (`tcfg.remat`)."""
    def loss(x, y, valid=None):
        if tcfg.remat and torch.is_grad_enabled():
            return checkpoint(vgg_perceptual_loss, vgg_model, x, y, valid, use_reentrant=False,
                              preserve_rng_state=False)
        return vgg_perceptual_loss(vgg_model, x, y, valid)
    return loss


@torch.no_grad()
def _conditioning(tables, mano_params, batch, ccfg):
    return hand_recovery_flow(tables, mano_params, batch["imageA"], batch["imageB"],
                              batch["manoA"], batch["manoB"], ccfg)


def _d_losses(d_model, tcfg: TrainConfig, flow, batch, fake_tsf):
    """D loss on the real target and the detached fake, and the two logit means."""
    _, armask_tsf = _armasks(batch, tcfg)
    cond = _d_cond(flow, armask_tsf)
    d_real = d_model(torch.cat([_nhwc(batch["imageB"]), cond], dim=-1))
    d_fake = d_model(torch.cat([fake_tsf.detach(), cond], dim=-1))
    loss = (lsgan_loss(d_real, 1.0) + lsgan_loss(d_fake, -1.0)) * tcfg.lambda_D_prob
    return loss, {"d_real": d_real.mean(), "d_fake": d_fake.mean()}


def make_train_step(vgg_model, tables: dict, mano_params: dict, ccfg: ConditioningConfig,
                    tcfg: TrainConfig, sync=None) -> Callable:
    """Returns train_step(state, batch, d_trainable) -> (state, metrics).

    batch: dict of tensors on the networks' device with imageA / imageB
    (B, 3, S, S) in [-1, 1], optional maskA / maskB (B, 1, S, S) and the
    manoA / manoB theta dicts. d_trainable: a host bool; False leaves D's
    parameters and its Adam state untouched (loss_D, d_real and d_fake are
    still returned). `state` is updated in place and returned.

    sync: None for one process, or a `hoig_torch.parallel.DataParallel` of
    `state` for data-parallel training. It then agrees on rank 0's
    d_trainable, zeroes each network's flat gradient buffer before its
    backward, averages the gradients over the ranks after it (before the
    Adam step), and averages the metrics."""
    vgg_loss = _train_vgg_loss(vgg_model, tcfg)

    def zero_grad(opt, net: str):
        if sync is None:
            opt.zero_grad(set_to_none=True)
        else:
            sync.zero_grad(net)

    def train_step(state: TrainState, batch: dict, d_trainable: bool):
        with annotate("train_step"):
            return _step(state, batch, d_trainable)

    def _step(state: TrainState, batch: dict, d_trainable: bool):
        if sync is not None:
            # the ranks' gates come from their own clocks: a rank that skipped
            # D's backward would leave the others waiting in its all-reduce
            d_trainable = sync.agree(d_trainable)
        with annotate("conditioning"):
            flow = _conditioning(tables, mano_params, batch, ccfg)
        g_params = [p for p in state.g.parameters() if p.requires_grad]
        fakes, loss_g, parts, _ = _forward_and_g_losses(state.g, state.d, vgg_loss, tcfg, flow,
                                                        batch)
        zero_grad(state.opt_g, "g")
        with annotate("g_backward"):
            loss_g.backward(inputs=g_params)  # w.r.t. G only: D's .grad stays untouched
        if sync is not None:
            sync.reduce_grads("g")
        with annotate("g_adam"):
            state.opt_g.step()

        if d_trainable:
            d_params = [p for p in state.d.parameters() if p.requires_grad]
            with annotate("d_losses"):
                loss_d, d_aux = _d_losses(state.d, tcfg, flow, batch, fakes[1])
            zero_grad(state.opt_d, "d")
            with annotate("d_backward"):
                loss_d.backward(inputs=d_params)
            if sync is not None:
                sync.reduce_grads("d")
            with annotate("d_adam"):
                state.opt_d.step()
        else:
            with torch.no_grad(), annotate("d_losses"):
                loss_d, d_aux = _d_losses(state.d, tcfg, flow, batch, fakes[1])
        state.step += 1
        metrics = {k: v.detach() for k, v in
                   {"loss_G": loss_g, "loss_D": loss_d, **parts, **d_aux}.items()}
        if sync is not None:
            metrics = sync.mean_metrics(metrics)
        return state, metrics

    return train_step


def make_g_grads_fn(vgg_model, tables: dict, mano_params: dict, ccfg: ConditioningConfig,
                    tcfg: TrainConfig) -> Callable:
    """grads_fn(g_model, d_model, batch) -> {parameter name: gradient of the
    G loss}: the raw gradients, before Adam (whose first step moves every
    parameter with a non-zero gradient by +-lr and so magnifies rounding
    noise), which is what equivalence tests compare."""
    vgg_loss = _train_vgg_loss(vgg_model, tcfg)

    def grads_fn(g_model, d_model, batch):
        flow = _conditioning(tables, mano_params, batch, ccfg)
        _, total, _, _ = _forward_and_g_losses(g_model, d_model, vgg_loss, tcfg, flow, batch)
        named = [(n, p) for n, p in g_model.named_parameters() if p.requires_grad]
        grads = torch.autograd.grad(total, [p for _, p in named])
        return {n: g for (n, _), g in zip(named, grads)}

    return grads_fn


def make_eval_metrics(vgg_model, tcfg: TrainConfig) -> Callable:
    """Returns eval_fn(g_model, d_model, flow, batch, valid=None) -> (fakes,
    metrics): the SAME loss graph as the train step, without gradients or
    updates. fakes = (fake_src, fake_tsf, src_mbg, src_mh, tsf_mbg, tsf_mh)."""

    @torch.no_grad()
    def eval_fn(g_model, d_model, flow, batch, valid=None):
        fakes, _, parts, d_fake = _forward_and_g_losses(
            g_model, d_model, lambda x, y, w=None: vgg_perceptual_loss(vgg_model, x, y, w),
            tcfg, flow, batch, valid=valid)
        _, armask_tsf = _armasks(batch, tcfg)
        d_real = d_model(torch.cat([_nhwc(batch["imageB"]), _d_cond(flow, armask_tsf)], dim=-1))
        return fakes, dict(parts, d_real=wmean(d_real, valid), d_fake=wmean(d_fake, valid))

    return eval_fn


def _adam(module: torch.nn.Module, lr: float, tcfg: TrainConfig) -> torch.optim.Adam:
    params = [p for p in module.parameters() if p.requires_grad]
    return torch.optim.Adam(params, lr=lr, betas=(tcfg.adam_b1, tcfg.adam_b2), eps=1e-8)


def init_state(g_model, d_model, tcfg: TrainConfig) -> TrainState:
    """A fresh TrainState around the two networks (see `build_networks`)."""
    return TrainState(g=g_model, d=d_model, opt_g=_adam(g_model, tcfg.lr_G, tcfg),
                      opt_d=_adam(d_model, tcfg.lr_D, tcfg), step=0, lr_g=tcfg.lr_G,
                      lr_d=tcfg.lr_D)


def set_lr(state: TrainState, lr_g: float, lr_d: float) -> TrainState:
    """Set both learning rates, in the state and in the optimizers."""
    state.lr_g, state.lr_d = lr_g, lr_d
    for opt, lr in ((state.opt_g, lr_g), (state.opt_d, lr_d)):
        for group in opt.param_groups:
            group["lr"] = lr
    return state


def decay_lr(state: TrainState, tcfg: TrainConfig) -> TrainState:
    """Linear per-epoch decay: lr -= (lr0 - final_lr) / nepochs_decay."""
    return set_lr(state, state.lr_g - (tcfg.lr_G - tcfg.final_lr) / tcfg.nepochs_decay,
                  state.lr_d - (tcfg.lr_D - tcfg.final_lr) / tcfg.nepochs_decay)
