"""The plain HOGAN training step and serving call, in blocks of rows.

The step (the reference's GAN objective as `scripts/train_*_ddp.sh` sets
it): the conditioning, the generator, the composite, the G loss (LSGAN
against 0 on D(fake), L1 reconstruction of the source, the VGG19 perceptual
loss on the target, BCE mask losses against the conditioning's crop masks,
TV smoothness of the masks) and G's Adam update; then the D loss (LSGAN, 1
on the real target, -1 on the detached fake, D's parameters from before the
step) and D's Adam update. Every loss term is a mean over equal-sized rows,
so a batch run in blocks of rows and averaged gives the batch's losses and
gradients: the reference fits on the card at any batch. The conditioning
runs on the whole batch, as the program runs it: MANO's batched products
round by the batch's size, and a last-bit change of a vertex can move a
rasterized pixel.
"""

from __future__ import annotations

import torch

from benchmark.reference import conditioning as cond
from benchmark.reference.networks import VGG_WEIGHTS

# what a configuration file may say; the values here are the only ones the
# reference implements (remat, the corner engine and the compute dtype
# change how the program computes, not what)
CONFIG_KEYS = {
    "name", "source", "setting", "reduced", "assumed", "gen_name", "image_size", "conv_dim",
    "repeat_num", "bg_dim", "img_dim", "obj_dim", "img_cond_dim", "obj_cond_dim", "d_input_nc",
    "d_norm_type", "use_armask", "with_masks", "camera_model", "mano_pca_comps",
    "mano_flat_hand_mean", "num_objects", "lr_G", "lr_D", "adam_b1", "adam_b2",
    "lambda_D_prob", "lambda_rec", "lambda_tsf", "lambda_mask", "lambda_mask_smooth",
    "use_vgg", "mask_bce", "compute_dtype", "remat", "remat_bottleneck", "remat_attn",
    "corner_engine"}
FIXED = {"gen_name": "generator_spade_attn", "d_norm_type": "instance", "use_vgg": True,
         "mask_bce": True}


def check_config(cfg: dict) -> None:
    """Raise where a configuration has a key the harness does not read or
    a value the reference does not implement."""
    unknown = set(cfg) - CONFIG_KEYS
    if unknown:
        raise ValueError(f"configuration keys nothing reads: {sorted(unknown)}")
    for k, v in FIXED.items():
        if cfg.get(k) != v:
            raise ValueError(f"configuration {k}={cfg.get(k)!r}: the reference implements {v!r}")


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _clamped_log(x):
    return torch.where(x > 0, torch.log(x.clamp_min(torch.finfo(torch.float32).tiny)),
                       torch.full_like(x, -100.0)).clamp_min(-100.0)


def bce(p, t):
    return -(t * _clamped_log(p) + (1.0 - t) * _clamped_log(1.0 - p)).mean()


def tv(m):
    """NHWC mask smoothness: mean |dx| + mean |dy|."""
    return (m[:, :, :-1] - m[:, :, 1:]).abs().mean() + (m[:, :-1] - m[:, 1:]).abs().mean()


def generator_inputs(flow: dict, batch: dict, cfg: dict) -> tuple:
    arm = cfg["use_armask"]
    return (_nhwc(flow["input_G_src_bg"]), _nhwc(flow["input_G_src_obj"][:, :3]),
            _nhwc(flow["input_G_tsf_obj"][:, :3]), _nhwc(flow["input_G_src_hand"][:, :3]),
            _nhwc(flow["input_G_tsf_hand"][:, :3]), flow["T"],
            _nhwc(flow["input_G_src_obj"][:, 3:]), _nhwc(flow["input_G_src_hand"][:, 3:]),
            _nhwc(flow["input_G_tsf_obj"][:, 3:]), _nhwc(flow["input_G_tsf_hand"][:, 3:]),
            _nhwc(batch["maskA"]) if arm else None, _nhwc(batch["maskB"]) if arm else None)


def composite(outs):
    """fake = m_bg * bg + (1 - m_bg) * (obj * m_hand + hand * (1 - m_hand));
    -> (fake_src, fake_tsf, src_mask_bg, src_mask_hand, tsf_mask_bg, tsf_mask_hand)."""
    s_bg, t_bg, s_obj, s_hand, s_mbg, s_mh, t_obj, t_hand, t_mbg, t_mh = outs
    return (s_mbg * s_bg + (1 - s_mbg) * (s_obj * s_mh + s_hand * (1 - s_mh)),
            t_mbg * t_bg + (1 - t_mbg) * (t_obj * t_mh + t_hand * (1 - t_mh)),
            s_mbg, s_mh, t_mbg, t_mh)


def d_condition(flow: dict, batch: dict, cfg: dict):
    parts = [_nhwc(flow["input_G_tsf_obj"][:, 3:]), _nhwc(flow["input_G_tsf_hand"][:, 3:])]
    if cfg["use_armask"]:
        parts.append(_nhwc(batch["maskB"]))
    return torch.cat(parts, dim=-1)


def blocks(batch: dict, rows: int):
    """The batch (or its conditioning) split into blocks of `rows` rows."""
    n = (batch["imageA"] if "imageA" in batch else next(iter(batch.values()))).shape[0]
    for at in range(0, n, rows):
        yield {k: ({kk: vv[at:at + rows] for kk, vv in v.items()} if isinstance(v, dict)
                   else v[at:at + rows]) for k, v in batch.items()}


def g_loss(nets, flow, batch, cfg, keep=None):
    """The G loss of one block and its detached fake target image; `keep`
    (a list) receives the generator's inputs and raw outputs."""
    g_in = generator_inputs(flow, batch, cfg)
    outs = nets["g"](*g_in)
    if keep is not None:
        keep.append((g_in, tuple(o.detach() for o in outs)))
    fakes = composite(outs)
    f_src, f_tsf, s_mbg, s_mh, t_mbg, t_mh = fakes
    d_fake = nets["d"](torch.cat([f_tsf, d_condition(flow, batch, cfg)], dim=-1))
    fx = nets["vgg"](f_tsf)
    with torch.no_grad():
        fy = nets["vgg"](_nhwc(batch["imageB"]))
    vgg = sum(w * (a - b).abs().mean() for w, a, b in zip(VGG_WEIGHTS, fx, fy))
    m_bg, m_h = torch.cat([s_mbg, t_mbg]), torch.cat([s_mh, t_mh])
    tgt_bg = torch.cat([_nhwc(flow["src_crop_mask_bg"]), _nhwc(flow["tsf_crop_mask_bg"])])
    tgt_h = torch.cat([_nhwc(flow["src_crop_mask_hand"]), _nhwc(flow["tsf_crop_mask_hand"])])
    total = ((d_fake ** 2).mean() * cfg["lambda_D_prob"]
             + (f_src - _nhwc(batch["imageA"])).abs().mean() * cfg["lambda_rec"]
             + vgg * cfg["lambda_tsf"]
             + (bce(m_bg, tgt_bg) + bce(m_h, tgt_h)) * cfg["lambda_mask"]
             + (tv(m_bg) + tv(m_h)) * cfg["lambda_mask_smooth"])
    return total, f_tsf.detach()


def d_loss(nets, flow, batch, fake_tsf, cfg):
    c = d_condition(flow, batch, cfg)
    d_real = nets["d"](torch.cat([_nhwc(batch["imageB"]), c], dim=-1))
    d_fake = nets["d"](torch.cat([fake_tsf, c], dim=-1))
    return (((d_real - 1.0) ** 2).mean() + ((d_fake + 1.0) ** 2).mean()) * cfg["lambda_D_prob"]


class Adam:
    """torch.optim.Adam's update (no weight decay, no amsgrad), written out."""

    def __init__(self, params: dict, lr: float, betas: tuple, eps: float = 1e-8):
        self.params, self.lr, self.b1, self.b2, self.eps = params, lr, betas[0], betas[1], eps
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: dict) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, p in self.params.items():
            g = grads[k]
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = (self.v[k].sqrt() / c2 ** 0.5).add_(self.eps)
            p.addcdiv_(self.m[k], denom, value=-self.lr / c1)


def _accumulate(acc: dict, params: dict, scale: float) -> None:
    for k, p in params.items():
        g = torch.zeros_like(p) if p.grad is None else p.grad * scale
        acc[k] = g if k not in acc else acc[k] + g
        p.grad = None


def train_steps(nets: dict, tables: dict, mano: dict, batches: list, cfg: dict, rows: int,
                prec) -> dict:
    """Run the steps on `batches` from the networks' current weights.

    Returns dict(losses [(loss_G, loss_D)] per step, grads {name: first
    step's gradient norm}, deltas {name: norm of the change of each
    parameter over all the steps}, first (the first step's generator inputs
    and raw outputs, each concatenated over the blocks)), names "g.<key>" /
    "d.<key>"."""
    params = {f"g.{k}": p for k, p in nets["g"].named_parameters()}
    params.update({f"d.{k}": p for k, p in nets["d"].named_parameters()})
    g_par = {k: p for k, p in params.items() if k.startswith("g.")}
    d_par = {k: p for k, p in params.items() if k.startswith("d.")}
    start = {k: p.detach().clone() for k, p in params.items()}
    lr, betas = cfg["lr_G"], (cfg["adam_b1"], cfg["adam_b2"])
    opt_g, opt_d = Adam(g_par, lr, betas), Adam(d_par, cfg["lr_D"], betas)
    losses, first, kept = [], None, []
    for batch in batches:
        n = batch["imageA"].shape[0]
        parts = list(blocks(batch, rows))
        flows = list(blocks(cond.hand_recovery_flow(tables, mano, batch, cfg, prec), rows))
        gg, lg, fakes = {}, 0.0, []
        for p, flow in zip(parts, flows):
            loss, fake = g_loss(nets, flow, p, cfg, kept if first is None else None)
            w = p["imageA"].shape[0] / n
            (loss * w).backward(inputs=list(g_par.values()))
            _accumulate(gg, g_par, 1.0)
            lg += float(loss.detach()) * w
            fakes.append(fake)
        for p in d_par.values():
            p.grad = None
        dg, ld = {}, 0.0
        for p, flow, fake in zip(parts, flows, fakes):
            loss = d_loss(nets, flow, p, fake, cfg)
            w = p["imageA"].shape[0] / n
            (loss * w).backward(inputs=list(d_par.values()))
            _accumulate(dg, d_par, 1.0)
            ld += float(loss.detach()) * w
        if first is None:
            first = {k: float(v.norm()) for k, v in {**gg, **dg}.items()}
        opt_g.step(gg)
        opt_d.step(dg)
        losses.append((lg, ld))
    deltas = {k: float((p.detach() - start[k]).norm()) for k, p in params.items()}
    cat = lambda parts: None if parts[0] is None else torch.cat(parts)
    g_first = (tuple(cat(x) for x in zip(*[i for i, _ in kept])),
               tuple(cat(x) for x in zip(*[o for _, o in kept])))
    return dict(losses=losses, grads=first, deltas=deltas, first=g_first)


@torch.no_grad()
def serve(nets: dict, tables: dict, mano: dict, batch: dict, cfg: dict, rows: int, prec) -> tuple:
    """(conditioning, composite outputs) of one serving call; the generator
    in blocks of rows."""
    flow = cond.hand_recovery_flow(tables, mano, batch, cfg, prec)
    outs = [composite(nets["g"](*generator_inputs(f, p, cfg)))
            for f, p in zip(blocks(flow, rows), blocks(batch, rows))]
    return flow, tuple(torch.cat(o) for o in zip(*outs))
