"""HOGAN generator family (port of hoig_tpu/models/generator.py).

  * ResNetGenerator: background branch (tanh RGB).
  * ResUnetGenerator: 3-down U-net with residual bottleneck, skip convs,
    SPADE variants and the RGB / hand-attention / bg-attention heads,
    evaluated as one packed 5-channel conv.
  * Generator: bg / obj / src / tsf sub-nets; the src and tsf hand encoders
    run in lockstep and at every layer 1..n_down+repeat_num the src feature
    is warped into tsf space by the flow T (grid_sample, or the flow-guided
    local attention ExtractorAttn) and added.

Reference quirks kept: the attention reads a normalized-coordinate flow
delta in pixel units, the identity grid subtracted from T is 'ij'-indexed,
and the plain warp uses align_corners=False while T is resized with
align_corners=True. Public inputs and outputs are NHWC, as in the JAX
package.

Activation rematerialization (the JAX package's `remat`, `remat_bottleneck`
and `remat_attn` switches): with `remat` the conv blocks of the encoders and
decoders recompute their forward in the backward pass
(`torch.utils.checkpoint`, non-reentrant); the bottleneck's residual blocks
do so only with `remat_bottleneck` as well, the attention layers only with
`remat_attn`. Each rematerialized region keeps its InstanceNorm statistics
for the recompute, as the JAX package's `in_stats` policy keeps them
(models/layers.py, `keep_stats`). Values and state-dict keys do not depend
on the switches.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from hoig_torch.models.layers import (
    Conv2d,
    ResidualBlock,
    SPADEBlock,
    SPADEResidualBlock,
    conv_in_relu,
    keep_stats,
    upconv_in_relu,
)
from hoig_torch.ops.attn_fused import edge_pad, flow_attention_fused, flow_fields
from hoig_torch.ops.grid_sample import _resize_axis_linear_ac, grid_sample_nhwc
from hoig_torch.ops.local_combine import local_combine
from hoig_torch.ops.table_gather import gather_rows_nhwc


def _run(module: nn.Module, remat: bool, *args):
    """module(*args), rematerialized in the backward pass when asked; the
    recompute takes the forward's InstanceNorm statistics back (`keep_stats`)."""
    if remat and torch.is_grad_enabled():
        return checkpoint(keep_stats(module), *args, use_reentrant=False,
                          preserve_rng_state=False)
    return module(*args)


def _to_net(x_nhwc: torch.Tensor) -> torch.Tensor:
    """NHWC -> NCHW view in channels_last memory (a copy only if needed)."""
    return x_nhwc.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _conv_nhwc(x: torch.Tensor, w_oihw: torch.Tensor) -> torch.Tensor:
    """VALID correlation of an NHWC tensor; NHWC out."""
    return _nhwc(F.conv2d(x.permute(0, 3, 1, 2), w_oihw)).contiguous()


def _resize_flow(t: torch.Tensor, hw: int) -> torch.Tensor:
    """Bilinear align_corners=True resize of (B, S, S, 2) to (B, hw, hw, 2)."""
    return _resize_axis_linear_ac(_resize_axis_linear_ac(t, 1, hw), 2, hw)


def _identity_grid_ij(h: int, dtype, device) -> torch.Tensor:
    """arange(-1, 1, 2/h) meshgrid, 'ij' indexing: x varies along rows."""
    v = -1.0 + 2.0 * torch.arange(h, dtype=dtype, device=device) / h
    return torch.stack([v[:, None].expand(h, h), v[None, :].expand(h, h)], dim=-1)[None]


class ExtractorAttn(nn.Module):
    """Flow-guided k x k local attention (reference extract_attn.py).

    Three engines with identical parameters: "shift" (bf16 pick) writes every
    bilinear corner as a bounded integer shift and evaluates both
    weighted-shift sums with the `local_combine` kernel; "gather" (f32 pick)
    fetches the (k+1)^2 shared corners with one row gather, whose backward
    is the fixed-order `scatter_rows` kernel; "pallas" (the JAX
    package's name for it, opt-in) runs the whole source half, softmax and
    weighted mean in the fused kernels of `ops/attn_fused.py` (k = 5 only).
    The flow is the reference's normalized delta read in pixels, bounded so
    that floor(flow) lies in [-3, 2]; the shift and fused engines are exact
    there.
    """

    _FLOOR_LO = -3
    _FLOOR_HI = 2

    def __init__(self, channels: int, kernel_size: int = 5, corner_engine: str = "gather",
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        if corner_engine not in ("shift", "gather", "pallas"):
            raise ValueError(f"unknown corner engine {corner_engine!r} (shift | gather | pallas)")
        k = kernel_size
        self.kernel_size = k
        self.corner_engine = corner_engine
        self.compute_dtype = compute_dtype
        # the reference's module layout: conv over the k^2-expanded blocks,
        # activation, 1x1 conv to k^2 logits (the weights are read directly)
        self.fully_connect_layer = nn.Sequential(
            nn.Conv2d(2 * channels, 128, k, stride=k), nn.LeakyReLU(0.01),
            nn.Conv2d(128, k * k, 1),
        )

    def forward(self, source: torch.Tensor, target: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
        """source, target (B, h, w, C) NHWC; flow (B, h, w, 2). Returns NHWC."""
        k = self.kernel_size
        r = k // 2
        b, h, w, c = source.shape
        cd = self.compute_dtype
        fc0, fc1 = self.fully_connect_layer[0], self.fully_connect_layer[2]
        w0c = fc0.weight.to(cd)  # (128, 2C, k, k)
        # target half of fc_0: replicate-pad VALID correlation
        tpad = edge_pad(target.to(cd), r)
        acc = _conv_nhwc(tpad, w0c[:, :c]) + fc0.bias.to(cd)
        if self.corner_engine == "pallas":
            return self._pallas_engine(source, acc, w0c, flow)

        f32 = torch.float32
        dev = source.device
        xf = torch.arange(w, dtype=f32, device=dev)[None, :].expand(h, w)
        yf = torch.arange(h, dtype=f32, device=dev)[:, None].expand(h, w)
        fx = flow[..., 0].float() + xf
        fy = flow[..., 1].float() + yf
        x0f, y0f = fx.floor(), fy.floor()
        wx = {1: (fx - x0f)[..., None].to(cd)}
        wy = {1: (fy - y0f)[..., None].to(cd)}
        wx[0] = 1.0 - wx[1]
        wy[0] = 1.0 - wy[1]
        x0, y0 = x0f.long(), y0f.long()
        w1 = fc1.weight.reshape(k * k, 128).t().to(cd)
        b1 = fc1.bias.to(cd)
        if self.corner_engine == "shift":
            return self._shift_engine(source, acc, w0c, w1, b1, wy, wx, x0, y0, xf, yf)
        return self._gather_engine(source, acc, w0c, w1, b1, wy, wx, x0, y0)

    def _attention(self, acc, w1, b1):
        hdn = F.leaky_relu(acc, 0.01)
        logits = hdn @ w1 + b1
        return torch.softmax(logits.float(), dim=-1).to(self.compute_dtype)

    def _shift_engine(self, source, acc, w0c, w1, b1, wy, wx, x0, y0, xf, yf):
        k = self.kernel_size
        r = k // 2
        b, h, w, c = source.shape
        cd = self.compute_dtype
        lo, hi = self._FLOOR_LO, self._FLOOR_HI
        pad = r + hi + 1  # largest total shift

        src_c = source.to(cd)
        fy_rel = (y0 - yf.long()).clamp(lo, hi)
        fx_rel = (x0 - xf.long()).clamp(lo, hi)
        ev = torch.arange(lo, hi + 1, device=source.device)
        oh_y = (fy_rel[..., None] == ev).to(cd)
        oh_x = (fx_rel[..., None] == ev).to(cd)
        # per-axis weights on the 7 integer shifts: A[e] = w0 [f == e] + w1 [f == e-1]
        ay = F.pad(oh_y, (0, 1)) * wy[0] + F.pad(oh_y, (1, 0)) * wy[1]
        ax = F.pad(oh_x, (0, 1)) * wx[0] + F.pad(oh_x, (1, 0)) * wx[1]
        n_e = hi - lo + 2

        # source half of fc_0: the coefficient fields do not depend on the
        # attention offset, so it is one correlation G plus a 49-shift combine
        src_pad = edge_pad(src_c, pad)
        halo = hi + 1
        g = _conv_nhwc(src_pad, w0c[:, c:])  # (B, h + 2 halo, w + 2 halo, 128)
        axy = (ay[..., :, None] * ax[..., None, :]).reshape(b, h, w, n_e * n_e)
        acc = acc + local_combine(g, axy.contiguous(), halo).to(acc.dtype)
        attn = self._attention(acc, w1, b1)

        # output half: out[p] = sum_d V_d[p] src[p + d], V built separably
        n_d = 2 * pad + 1
        attn5 = attn.reshape(b, h, w, k, k)
        vx = None
        for exi in range(n_e):
            term = F.pad(ax[..., exi, None, None] * attn5, (exi, n_e - 1 - exi))
            vx = term if vx is None else vx + term
        v = None
        for eyi in range(n_e):
            term = F.pad(ay[..., eyi, None, None] * vx, (0, 0, eyi, n_e - 1 - eyi))
            v = term if v is None else v + term
        out = local_combine(src_pad, v.reshape(b, h, w, n_d * n_d).contiguous(), pad)
        return (out.to(cd) / (k * k)).to(source.dtype)

    def _pallas_engine(self, source, acc, w0c, flow):
        """The fused kernels: fc_0's source half as (25, C, 128) offset-major
        slices of the same weight, acc0 and fc_1 in f32, the output cast to
        the source's dtype."""
        k = self.kernel_size
        if k != 5:
            raise NotImplementedError("the pallas corner engine requires kernel_size 5")
        c = source.shape[3]
        cd = self.compute_dtype
        fc1 = self.fully_connect_layer[2]
        w0s = w0c[:, c:].permute(2, 3, 1, 0).reshape(k * k, c, 128).contiguous()
        w1 = fc1.weight.reshape(k * k, 128).t().float().contiguous()
        b1 = fc1.bias.float()[None]
        out = flow_attention_fused(source.to(cd).contiguous(), acc.float().contiguous(), w0s, w1,
                                   b1, *flow_fields(flow))
        return out.to(source.dtype)

    def _gather_engine(self, source, acc, w0c, w1, b1, wy, wx, x0, y0):
        k = self.kernel_size
        r = k // 2
        b, h, w, c = source.shape
        cd = self.compute_dtype
        corners = [(ry, rx) for ry in range(-r, r + 2) for rx in range(-r, r + 2)]
        # all (k+1)^2 border-clamped corners floor(flow) + (rx, ry) in one
        # row gather of the batch-flattened source, corner-major, so that each
        # corner is a contiguous (B, hw, C) block and the backward is one
        # fixed-order scatter_rows
        dev = source.device
        off = torch.arange(-r, r + 2, device=dev)
        off_y = off[:, None].expand(k + 1, k + 1).reshape(-1, 1, 1, 1)
        off_x = off[None, :].expand(k + 1, k + 1).reshape(-1, 1, 1, 1)
        base = (torch.arange(b, device=dev) * (h * w)).view(1, b, 1, 1)
        idx = base + (y0 + off_y).clamp(0, h - 1) * w + (x0 + off_x).clamp(0, w - 1)
        rows = gather_rows_nhwc(source.to(cd).reshape(1, b * h * w, c), idx.reshape(1, -1))
        fetched = dict(zip(corners, rows.reshape(len(corners), b, h * w, c).unbind(0)))

        def offsets_touching(ry: int, rx: int):
            """The <= 4 (corner weight, offset) pairs that read corner (ry, rx)."""
            out = []
            for cy in (0, 1):
                dy = ry - cy
                if not -r <= dy <= r:
                    continue
                for cx in (0, 1):
                    dx = rx - cx
                    if -r <= dx <= r:
                        out.append((cy, cx, dy + r, dx + r))
            return out

        w_src = w0c[:, c:]  # (128, C, k, k)
        for ry, rx in corners:
            ts = offsets_touching(ry, rx)
            wstk = torch.cat([w_src[:, :, oy, ox].t() for _, _, oy, ox in ts], dim=-1)
            mm = (fetched[ry, rx] @ wstk).reshape(b, h, w, len(ts) * 128)
            for j, (cy, cx, _, _) in enumerate(ts):
                acc = acc + (wy[cy] * wx[cx]) * mm[..., j * 128:(j + 1) * 128]
        attn = self._attention(acc, w1, b1)

        out = torch.zeros((b, h, w, c), dtype=cd, device=source.device)
        for ry, rx in corners:
            cw = None
            for cy, cx, oy, ox in offsets_touching(ry, rx):
                t_idx = oy * k + ox
                term = (wy[cy] * wx[cx]) * attn[..., t_idx:t_idx + 1]
                cw = term if cw is None else cw + term
            out = out + cw * fetched[ry, rx].reshape(b, h, w, c)
        return (out / (k * k)).to(source.dtype)


class ResNetGenerator(nn.Module):
    """Background branch: encoder, residual bottleneck, decoder, tanh RGB."""

    def __init__(self, in_dim: int, conv_dim: int = 64, repeat_num: int = 6, k_size: int = 3,
                 n_down: int = 3, compute_dtype: torch.dtype = torch.float32,
                 remat: bool = True, remat_bottleneck: bool = True):
        super().__init__()
        cd = compute_dtype
        self.n_down, self.repeat_num = n_down, repeat_num
        self.remat, self.remat_mid = remat, remat and remat_bottleneck
        layers = list(conv_in_relu(in_dim, conv_dim, 7, 1, 3, cd))
        dim = conv_dim
        for _ in range(n_down):
            layers += list(conv_in_relu(dim, dim * 2, k_size, 2, 1, cd))
            dim *= 2
        layers += [ResidualBlock(dim, cd) for _ in range(repeat_num)]
        for _ in range(n_down):
            layers += list(upconv_in_relu(dim, dim // 2, k_size, cd))
            dim //= 2
        layers += [Conv2d(dim, 3, 7, 1, 3, bias=False, compute_dtype=cd), nn.Tanh()]
        self.model = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        m, i = self.model, 0
        for _ in range(1 + self.n_down):  # conv-IN-ReLU triples
            x = _run(m[i:i + 3], self.remat, x)
            i += 3
        for _ in range(self.repeat_num):
            x = _run(m[i], self.remat_mid, x)
            i += 1
        for _ in range(self.n_down):  # upconv-IN-ReLU triples
            x = _run(m[i:i + 3], self.remat, x)
            i += 3
        return m[i + 1](m[i](x))


class ResUnetGenerator(nn.Module):
    """U-net branch with per-stage calls, so `Generator` can drive the src
    and tsf copies in lockstep."""

    def __init__(self, in_dim: int, cond_dim: int, conv_dim: int = 64, repeat_num: int = 6,
                 k_size: int = 3, n_down: int = 3, spade_layers: Sequence[int] = (0, 0, 0, 0),
                 on_obj: bool = False, compute_dtype: torch.dtype = torch.float32,
                 remat: bool = True, remat_bottleneck: bool = True):
        super().__init__()
        cd = self.compute_dtype = compute_dtype
        self.remat, self.remat_mid = remat, remat and remat_bottleneck
        self.n_down, self.repeat_num = n_down, repeat_num
        self.spade_layers, self.on_obj = tuple(spade_layers), on_obj
        dim = conv_dim
        enc = [conv_in_relu(in_dim, dim, 7, 1, 3, cd)]
        for _ in range(n_down):
            if spade_layers[0]:
                enc.append(SPADEBlock(dim, dim * 2, k_size, True, cond_dim, cd))
            else:
                enc.append(conv_in_relu(dim, dim * 2, k_size, 2, 1, cd))
            dim *= 2
        self.encoders = nn.ModuleList(enc)
        self.resnets = nn.ModuleList([
            SPADEResidualBlock(dim, cond_dim, cd) if self._res_spade(i) else ResidualBlock(dim, cd)
            for i in range(repeat_num)
        ])
        decs, skips = [], []
        for _ in range(n_down):
            if spade_layers[3]:
                decs.append(SPADEBlock(dim, dim // 2, k_size, False, cond_dim, cd))
            else:
                decs.append(upconv_in_relu(dim, dim // 2, k_size, cd))
            skips.append(conv_in_relu(dim, dim // 2, k_size, 1, 1, cd))
            dim //= 2
        self.decoders = nn.ModuleList(decs)
        self.skippers = nn.ModuleList(skips)
        self.img_reg = nn.Sequential(Conv2d(conv_dim, 3, 7, 1, 3, bias=False, compute_dtype=cd),
                                     nn.Tanh())
        if not on_obj:
            # reference spelling
            self.attetion_reg_hand = nn.Sequential(
                Conv2d(conv_dim, 1, 7, 1, 3, bias=False, compute_dtype=cd), nn.Sigmoid())
            self.attetion_reg_bg = nn.Sequential(
                Conv2d(2 * conv_dim, 1, 7, 1, 3, bias=False, compute_dtype=cd), nn.Sigmoid())

    def _res_spade(self, i: int) -> bool:
        return bool(self.spade_layers[1] if i < self.repeat_num // 2 else self.spade_layers[2])

    def encode_layer(self, i: int, x: torch.Tensor, seg):
        if i > 0 and self.spade_layers[0]:
            return _run(self.encoders[i], self.remat, x, seg)
        return _run(self.encoders[i], self.remat, x)

    def resnet_layer(self, i: int, x: torch.Tensor, seg):
        if self._res_spade(i):
            return _run(self.resnets[i], self.remat_mid, x, seg)
        return _run(self.resnets[i], self.remat_mid, x)

    def encode(self, x, seg=None):
        outs = [self.encode_layer(0, x, seg)]
        for i in range(1, self.n_down + 1):
            outs.append(self.encode_layer(i, outs[-1], seg))
        return outs

    def bottleneck(self, x, seg=None):
        for i in range(self.repeat_num):
            x = self.resnet_layer(i, x, seg)
        return x

    def decode(self, x, encoder_outs, seg=None):
        for i in range(self.n_down):
            if self.spade_layers[3]:
                x = _run(self.decoders[i], self.remat, x, seg)
            else:
                x = _run(self.decoders[i], self.remat, x)
            x = _run(self.skippers[i], self.remat,
                     torch.cat([encoder_outs[self.n_down - 1 - i], x], dim=1))
        return x

    def regress(self, x, y=None):
        if self.on_obj:
            return self.img_reg(x)
        # the three heads as ONE 7x7 conv over [x, y] -> 5 channels; the
        # RGB and hand heads read only the x channels (zero y block)
        cd = self.compute_dtype
        kx = torch.cat([self.img_reg[0].weight, self.attetion_reg_hand[0].weight], dim=0)
        kx = F.pad(kx, (0, 0, 0, 0, 0, y.shape[1]))
        kw = torch.cat([kx, self.attetion_reg_bg[0].weight], dim=0).to(cd)
        out = F.conv2d(torch.cat([x, y], dim=1).to(cd), kw, None, 1, 3)
        return torch.tanh(out[:, 0:3]), torch.sigmoid(out[:, 3:4]), torch.sigmoid(out[:, 4:5])

    def forward(self, x, seg=None):
        outs = self.encode(x, seg)
        return self.decode(self.bottleneck(outs[-1], seg), outs, seg)


class Generator(nn.Module):
    """Full HOGAN generator, NHWC in and out."""

    def __init__(self, bg_dim: int = 8, img_dim: int = 3, obj_dim: int = 3,
                 img_cond_dim: int = 0, obj_cond_dim: int = 0, conv_dim: int = 64,
                 repeat_num: int = 6, spade_layers: Sequence[int] = (0, 0, 0, 0),
                 attn_layers: Sequence[int] = (), n_down: int = 3,
                 corner_engine: str = "gather", compute_dtype: torch.dtype = torch.float32,
                 remat: bool = True, remat_bottleneck: bool = True, remat_attn: bool = True):
        super().__init__()
        cd = compute_dtype
        self.n_down, self.repeat_num = n_down, repeat_num
        self.remat_attn = remat and remat_attn
        rm = dict(remat=remat, remat_bottleneck=remat_bottleneck)
        self.spade_layers = tuple(spade_layers)
        # lockstep layers 1..n_down+repeat_num; named layers past them never run
        self.attn_layers = tuple(l for l in attn_layers if l <= n_down + repeat_num)
        self.bg_model = ResNetGenerator(bg_dim, conv_dim, repeat_num, 3, n_down, cd, **rm)
        self.obj_model = ResUnetGenerator(obj_dim, obj_cond_dim, conv_dim, repeat_num, 3, n_down,
                                          spade_layers, on_obj=True, compute_dtype=cd, **rm)
        self.src_model = ResUnetGenerator(img_dim, img_cond_dim, conv_dim, repeat_num, 3, n_down,
                                          spade_layers, compute_dtype=cd, **rm)
        self.tsf_model = ResUnetGenerator(img_dim, img_cond_dim, conv_dim, repeat_num, 3, n_down,
                                          spade_layers, compute_dtype=cd, **rm)
        for l in self.attn_layers:
            ch = conv_dim * 2 ** min(l, n_down)
            self.add_module(f"attn_{l}", ExtractorAttn(ch, 5, corner_engine, cd))

    def _transform(self, x, t, y, layer):
        """Warp src feature x (NCHW) into tsf space; returns NCHW."""
        t_scale = _resize_flow(t, x.shape[2])
        if layer in self.attn_layers:
            idt = _identity_grid_ij(x.shape[2], t_scale.dtype, t_scale.device)
            out = _run(getattr(self, f"attn_{layer}"), self.remat_attn,
                       _nhwc(x), _nhwc(y), t_scale - idt)
        else:
            out = grid_sample_nhwc(_nhwc(x), t_scale, align_corners=False)
        return out.permute(0, 3, 1, 2)

    def forward(self, bg_inputs, src_obj_inputs, tsf_obj_inputs, src_hand_inputs,
                tsf_hand_inputs, T, src_obj_conds=None, src_hand_conds=None,
                tsf_obj_conds=None, tsf_hand_conds=None, src_armask=None, tsf_armask=None):
        """NHWC inputs as the JAX Generator takes them; returns the 10 NHWC
        outputs (src_img_bg, tsf_img_bg, src_obj, src_hand, src_mask_bg,
        src_mask_hand, tsf_obj, tsf_hand, tsf_mask_bg, tsf_mask_hand)."""
        cat = lambda xs: torch.cat([x for x in xs if x is not None], dim=-1)
        if src_obj_conds is None or src_hand_conds is None:
            src_bg = cat([bg_inputs, src_obj_inputs[..., 3:]])
            tsf_bg = cat([bg_inputs, tsf_hand_inputs[..., 3:]])
        else:
            src_bg = cat([bg_inputs, src_hand_conds])
            tsf_bg = cat([bg_inputs, tsf_hand_conds])
        src_bg = cat([src_bg, src_armask])
        tsf_bg = cat([tsf_bg, tsf_armask])
        # shared params and per-sample norms: one pass at batch 2B
        bg_both = _nhwc(self.bg_model(_to_net(torch.cat([src_bg, tsf_bg], dim=0))))
        src_img_bg, tsf_img_bg = bg_both.chunk(2, dim=0)
        net = lambda x: None if x is None else _to_net(x)
        front = self.infer_front(
            net(src_obj_inputs), net(tsf_obj_inputs), net(src_hand_inputs),
            net(tsf_hand_inputs), T, net(src_obj_conds), net(src_hand_conds),
            net(tsf_obj_conds), net(tsf_hand_conds),
        )
        return (src_img_bg, tsf_img_bg) + tuple(_nhwc(o) for o in front)

    def infer_front(self, src_obj_inputs, tsf_obj_inputs, src_hand_inputs, tsf_hand_inputs, T,
                    src_obj_conds, src_hand_conds, tsf_obj_conds, tsf_hand_conds):
        """Lockstep src / tsf encoders with per-layer warp-and-add (NCHW)."""
        src_x = self.src_model.encode_layer(0, src_hand_inputs, src_hand_conds)
        tsf_x = self.tsf_model.encode_layer(0, tsf_hand_inputs, tsf_hand_conds)
        src_outs, tsf_outs = [src_x], [tsf_x]
        for i in range(1, self.n_down + 1):
            src_x = self.src_model.encode_layer(i, src_x, src_hand_conds)
            tsf_x = self.tsf_model.encode_layer(i, tsf_x, tsf_hand_conds)
            tsf_x = tsf_x + self._transform(src_x, T, tsf_x, i)
            src_outs.append(src_x)
            tsf_outs.append(tsf_x)
        for i in range(self.repeat_num):
            src_x = self.src_model.resnet_layer(i, src_x, src_hand_conds)
            tsf_x = self.tsf_model.resnet_layer(i, tsf_x, tsf_hand_conds)
            tsf_x = tsf_x + self._transform(src_x, T, tsf_x, i + self.n_down + 1)

        obj_in = torch.cat([src_obj_inputs, tsf_obj_inputs], dim=0)
        obj_seg = None if src_obj_conds is None else torch.cat([src_obj_conds, tsf_obj_conds], 0)
        y_both = self.obj_model(obj_in, obj_seg)
        src_y, tsf_y = y_both.chunk(2, dim=0)
        spade_dec = self.spade_layers[3]
        src_x = self.src_model.decode(src_x, src_outs, src_hand_conds if spade_dec else None)
        tsf_x = self.tsf_model.decode(tsf_x, tsf_outs, tsf_hand_conds if spade_dec else None)
        src_hand, src_mask_hand, src_mask_bg = self.src_model.regress(src_x, src_y)
        tsf_hand, tsf_mask_hand, tsf_mask_bg = self.tsf_model.regress(tsf_x, tsf_y)
        src_obj, tsf_obj = self.obj_model.regress(y_both).chunk(2, dim=0)
        return (src_obj, src_hand, src_mask_bg, src_mask_hand,
                tsf_obj, tsf_hand, tsf_mask_bg, tsf_mask_hand)
