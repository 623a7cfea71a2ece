"""Plain PyTorch HOGAN networks in float32: generator_spade_attn (the
background ResNet, the object and the two hand ResUnets with SPADE in the
encoder and the first half of the bottleneck, the flow-guided 5 x 5 local
attention at the 9 lockstep layers), the PatchGAN-4 discriminator and the
VGG19 feature pyramid.

A frozen copy of the plain mathematics (the reference's torch modules, NHWC
at the boundaries as the port takes them), with none of the port's
kernels, engines, remat or dtype casts. Parameter names are the
reference's state-dict keys, so one set of weights loads into both sides.
Every convolution and matrix product takes its operands through
`Precision.operand`.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from benchmark.reference.precision import FULL, Precision

N_DOWN = 3


class Conv(nn.Conv2d):
    def __init__(self, cin, cout, k, stride=1, pad=0, bias=True, prec: Precision = FULL):
        super().__init__(cin, cout, k, stride, pad, bias=bias)
        self.prec = prec

    def forward(self, x):
        q = self.prec.operand
        return F.conv2d(q(x), q(self.weight), self.bias, self.stride, self.padding)


class UpConv(nn.ConvTranspose2d):
    """2x transposed conv: kernel k, stride 2, padding 1, output padding k % 2."""

    def __init__(self, cin, cout, k, prec: Precision = FULL):
        super().__init__(cin, cout, k, 2, 1, output_padding=k % 2, bias=False)
        self.prec = prec

    def forward(self, x):
        q = self.prec.operand
        return F.conv_transpose2d(q(x), q(self.weight), None, 2, 1, self.output_padding)


class InstanceNorm(nn.Module):
    def __init__(self, n, affine=True):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(n)) if affine else None
        self.bias = nn.Parameter(torch.zeros(n)) if affine else None

    def forward(self, x):
        var, mean = torch.var_mean(x, dim=(2, 3), correction=0, keepdim=True)
        y = (x - mean) * torch.rsqrt(var + 1e-5)
        if self.weight is not None:
            y = y * self.weight[None, :, None, None] + self.bias[None, :, None, None]
        return y


def conv_in_relu(cin, cout, k, stride, pad, prec):
    return nn.Sequential(Conv(cin, cout, k, stride, pad, False, prec), InstanceNorm(cout), nn.ReLU())


def upconv_in_relu(cin, cout, k, prec):
    return nn.Sequential(UpConv(cin, cout, k, prec), InstanceNorm(cout), nn.ReLU())


class SPADE(nn.Module):
    def __init__(self, nc, label_nc, prec):
        super().__init__()
        self.param_free_norm = InstanceNorm(nc, affine=False)
        self.mlp_shared = nn.Sequential(Conv(label_nc, 128, 3, 1, 1, prec=prec), nn.ReLU())
        self.mlp_gamma = Conv(128, nc, 3, 1, 1, prec=prec)
        self.mlp_beta = Conv(128, nc, 3, 1, 1, prec=prec)

    def forward(self, x, seg):
        h, w = x.shape[2:]
        if seg.shape[2:] != x.shape[2:]:
            seg = F.interpolate(seg, size=(h, w), mode="nearest")
        actv = self.mlp_shared(seg)
        return self.param_free_norm(x) * (1.0 + self.mlp_gamma(actv)) + self.mlp_beta(actv)


class ResidualBlock(nn.Module):
    def __init__(self, dim, prec):
        super().__init__()
        self.main = nn.Sequential(Conv(dim, dim, 3, 1, 1, False, prec), InstanceNorm(dim), nn.ReLU(),
                                  Conv(dim, dim, 3, 1, 1, False, prec), InstanceNorm(dim))

    def forward(self, x):
        return x + self.main(x)


class SPADEResidualBlock(nn.Module):
    def __init__(self, dim, label_nc, prec):
        super().__init__()
        self.conv_0 = Conv(dim, dim, 3, 1, 1, prec=prec)
        self.conv_1 = Conv(dim, dim, 3, 1, 1, prec=prec)
        self.norm_0 = SPADE(dim, label_nc, prec)
        self.norm_1 = SPADE(dim, label_nc, prec)

    def forward(self, x, seg):
        y = self.conv_0(F.relu(self.norm_0(x, seg)))
        return x + self.conv_1(F.relu(self.norm_1(y, seg)))


class SPADEBlock(nn.Module):
    def __init__(self, cin, cout, k, label_nc, prec):
        super().__init__()
        self.conv = Conv(cin, cout, k, 2, 1, False, prec)
        self.norm = SPADE(cout, label_nc, prec)

    def forward(self, x, seg):
        return F.relu(self.norm(self.conv(x), seg))


class ResNetGenerator(nn.Module):
    def __init__(self, in_dim, cd, repeat, prec):
        super().__init__()
        layers = list(conv_in_relu(in_dim, cd, 7, 1, 3, prec))
        dim = cd
        for _ in range(N_DOWN):
            layers += list(conv_in_relu(dim, dim * 2, 3, 2, 1, prec))
            dim *= 2
        layers += [ResidualBlock(dim, prec) for _ in range(repeat)]
        for _ in range(N_DOWN):
            layers += list(upconv_in_relu(dim, dim // 2, 3, prec))
            dim //= 2
        layers += [Conv(dim, 3, 7, 1, 3, False, prec), nn.Tanh()]
        self.model = nn.Sequential(*layers)

    def forward(self, x):
        return self.model(x)


class ResUnetGenerator(nn.Module):
    """spade_layers (1, 1, 0, 0): SPADE encoder stages and first half of the
    bottleneck; plain decoder."""

    def __init__(self, in_dim, cond_dim, cd, repeat, on_obj, prec):
        super().__init__()
        self.repeat, self.on_obj, self.prec = repeat, on_obj, prec
        dim = cd
        enc = [conv_in_relu(in_dim, dim, 7, 1, 3, prec)]
        for _ in range(N_DOWN):
            enc.append(SPADEBlock(dim, dim * 2, 3, cond_dim, prec))
            dim *= 2
        self.encoders = nn.ModuleList(enc)
        self.resnets = nn.ModuleList([
            SPADEResidualBlock(dim, cond_dim, prec) if i < repeat // 2 else ResidualBlock(dim, prec)
            for i in range(repeat)])
        decs, skips = [], []
        for _ in range(N_DOWN):
            decs.append(upconv_in_relu(dim, dim // 2, 3, prec))
            skips.append(conv_in_relu(dim, dim // 2, 3, 1, 1, prec))
            dim //= 2
        self.decoders = nn.ModuleList(decs)
        self.skippers = nn.ModuleList(skips)
        self.img_reg = nn.Sequential(Conv(cd, 3, 7, 1, 3, False, prec), nn.Tanh())
        if not on_obj:
            self.attetion_reg_hand = nn.Sequential(Conv(cd, 1, 7, 1, 3, False, prec), nn.Sigmoid())
            self.attetion_reg_bg = nn.Sequential(Conv(2 * cd, 1, 7, 1, 3, False, prec), nn.Sigmoid())

    def encode_layer(self, i, x, seg):
        return self.encoders[i](x) if i == 0 else self.encoders[i](x, seg)

    def resnet_layer(self, i, x, seg):
        return self.resnets[i](x, seg) if i < self.repeat // 2 else self.resnets[i](x)

    def decode(self, x, outs):
        for i in range(N_DOWN):
            x = self.decoders[i](x)
            x = self.skippers[i](torch.cat([outs[N_DOWN - 1 - i], x], dim=1))
        return x

    def forward(self, x, seg):
        outs = [self.encode_layer(0, x, seg)]
        for i in range(1, N_DOWN + 1):
            outs.append(self.encode_layer(i, outs[-1], seg))
        x = outs[-1]
        for i in range(self.repeat):
            x = self.resnet_layer(i, x, seg)
        return self.decode(x, outs)

    def regress(self, x, y):
        """(rgb, hand attention, background attention) from x and, for the
        background head, the object branch's features y."""
        return (self.img_reg(x), self.attetion_reg_hand(x),
                self.attetion_reg_bg(torch.cat([x, y], dim=1)))


class ExtractorAttn(nn.Module):
    """Flow-guided k x k local attention: for each of the k^2 offsets the
    source is sampled bilinearly at floor(p + flow) + offset (corners clamped
    to the border); fc_0 (a k x k conv with stride k over the unfolded
    [target neighbourhood (edge-padded), sampled source] blocks), LeakyReLU,
    fc_1 (1x1) to k^2 logits, softmax, and the attention-weighted mean of the
    sampled source."""

    def __init__(self, channels, k=5, prec: Precision = FULL):
        super().__init__()
        self.k, self.prec = k, prec
        self.fully_connect_layer = nn.Sequential(nn.Conv2d(2 * channels, 128, k, stride=k),
                                                 nn.LeakyReLU(0.01), nn.Conv2d(128, k * k, 1))

    def forward(self, source, target, flow):
        """source, target (B, h, w, C); flow (B, h, w, 2) in pixels."""
        k, r, q = self.k, self.k // 2, self.prec.operand
        b, h, w, c = source.shape
        fc0, fc1 = self.fully_connect_layer[0], self.fully_connect_layer[2]
        w0 = q(fc0.weight)
        tpad = F.pad(target.permute(0, 3, 1, 2), (r,) * 4, mode="replicate")
        acc = F.conv2d(q(tpad), w0[:, :c], fc0.bias).permute(0, 2, 3, 1)
        dev = source.device
        fx = flow[..., 0] + torch.arange(w, dtype=torch.float32, device=dev)[None, :]
        fy = flow[..., 1] + torch.arange(h, dtype=torch.float32, device=dev)[:, None]
        x0, y0 = fx.floor(), fy.floor()
        wx1, wy1 = (fx - x0)[..., None], (fy - y0)[..., None]
        wx, wy = (1.0 - wx1, wx1), (1.0 - wy1, wy1)
        x0, y0 = x0.long(), y0.long()
        flat = source.reshape(b, h * w, c)

        corner = {}
        for dy in range(-r, r + 2):
            for dx in range(-r, r + 2):
                idx = (y0 + dy).clamp(0, h - 1) * w + (x0 + dx).clamp(0, w - 1)
                corner[dy, dx] = torch.gather(flat, 1, idx.reshape(b, h * w, 1).expand(-1, -1, c)
                                              ).reshape(b, h, w, c)
        sampled = []
        for oy in range(-r, r + 1):
            for ox in range(-r, r + 1):
                sampled.append(sum(wy[cy] * wx[cx] * corner[oy + cy, ox + cx]
                                   for cy in (0, 1) for cx in (0, 1)))
        w_src = w0[:, c:]
        for t, smp in enumerate(sampled):
            acc = acc + q(smp) @ w_src[:, :, t // k, t % k].t()
        hdn = F.leaky_relu(acc, 0.01)
        logits = q(hdn) @ q(fc1.weight.reshape(k * k, 128)).t() + fc1.bias
        attn = torch.softmax(logits, dim=-1)
        out = sum(attn[..., t:t + 1] * smp for t, smp in enumerate(sampled))
        return out / (k * k)


def _identity_grid_ij(h, device):
    v = -1.0 + 2.0 * torch.arange(h, dtype=torch.float32, device=device) / h
    return torch.stack([v[:, None].expand(h, h), v[None, :].expand(h, h)], dim=-1)[None]


def _resize_ac(x, axis, n):
    """Linear resize along `axis`, align_corners=True."""
    m = x.shape[axis]
    if m == n:
        return x
    pos = torch.arange(n, dtype=torch.float32, device=x.device) * ((m - 1) / (n - 1))
    i0 = pos.floor().long().clamp(0, m - 2)
    t = (pos - i0.float()).reshape([n if d == axis else 1 for d in range(x.dim())])
    return x.index_select(axis, i0) * (1 - t) + x.index_select(axis, i0 + 1) * t


class Generator(nn.Module):
    """NHWC in, the 10 NHWC outputs (src_bg, tsf_bg, src_obj, src_hand,
    src_mask_bg, src_mask_hand, tsf_obj, tsf_hand, tsf_mask_bg,
    tsf_mask_hand)."""

    def __init__(self, cfg: dict, prec: Precision = FULL):
        super().__init__()
        cd, rep = cfg["conv_dim"], cfg["repeat_num"]
        self.repeat = rep
        self.bg_model = ResNetGenerator(cfg["bg_dim"], cd, rep, prec)
        self.obj_model = ResUnetGenerator(cfg["obj_dim"], cfg["obj_cond_dim"], cd, rep, True, prec)
        self.src_model = ResUnetGenerator(cfg["img_dim"], cfg["img_cond_dim"], cd, rep, False, prec)
        self.tsf_model = ResUnetGenerator(cfg["img_dim"], cfg["img_cond_dim"], cd, rep, False, prec)
        for l in range(1, N_DOWN + rep + 1):
            self.add_module(f"attn_{l}", ExtractorAttn(cd * 2 ** min(l, N_DOWN), 5, prec))

    def _transform(self, x, t, y, layer):
        h = x.shape[2]
        t_scale = _resize_ac(_resize_ac(t, 1, h), 2, h)
        out = getattr(self, f"attn_{layer}")(x.permute(0, 2, 3, 1), y.permute(0, 2, 3, 1),
                                             t_scale - _identity_grid_ij(h, x.device))
        return out.permute(0, 3, 1, 2)

    def forward(self, bg, src_obj, tsf_obj, src_hand, tsf_hand, T, src_obj_c, src_hand_c,
                tsf_obj_c, tsf_hand_c, src_armask=None, tsf_armask=None):
        nchw = lambda x: x.permute(0, 3, 1, 2)
        nhwc = lambda x: x.permute(0, 2, 3, 1)
        extra = lambda m: [] if m is None else [m]
        src_bg = torch.cat([bg, src_hand_c] + extra(src_armask), dim=-1)
        tsf_bg = torch.cat([bg, tsf_hand_c] + extra(tsf_armask), dim=-1)
        bg_both = nhwc(self.bg_model(nchw(torch.cat([src_bg, tsf_bg]))))
        src_img_bg, tsf_img_bg = bg_both.chunk(2)
        sh, th, sc, tc = nchw(src_hand), nchw(tsf_hand), nchw(src_hand_c), nchw(tsf_hand_c)
        src_x = self.src_model.encode_layer(0, sh, sc)
        tsf_x = self.tsf_model.encode_layer(0, th, tc)
        src_outs, tsf_outs = [src_x], [tsf_x]
        for i in range(1, N_DOWN + 1):
            src_x = self.src_model.encode_layer(i, src_x, sc)
            tsf_x = self.tsf_model.encode_layer(i, tsf_x, tc)
            tsf_x = tsf_x + self._transform(src_x, T, tsf_x, i)
            src_outs.append(src_x)
            tsf_outs.append(tsf_x)
        for i in range(self.repeat):
            src_x = self.src_model.resnet_layer(i, src_x, sc)
            tsf_x = self.tsf_model.resnet_layer(i, tsf_x, tc)
            tsf_x = tsf_x + self._transform(src_x, T, tsf_x, i + N_DOWN + 1)
        y_both = self.obj_model(torch.cat([nchw(src_obj), nchw(tsf_obj)]),
                                torch.cat([nchw(src_obj_c), nchw(tsf_obj_c)]))
        src_y, tsf_y = y_both.chunk(2)
        src_x = self.src_model.decode(src_x, src_outs)
        tsf_x = self.tsf_model.decode(tsf_x, tsf_outs)
        s_rgb, s_mh, s_mbg = self.src_model.regress(src_x, src_y)
        t_rgb, t_mh, t_mbg = self.tsf_model.regress(tsf_x, tsf_y)
        src_o, tsf_o = self.obj_model.img_reg(y_both).chunk(2)
        return (src_img_bg, tsf_img_bg) + tuple(nhwc(o) for o in (
            src_o, s_rgb, s_mbg, s_mh, tsf_o, t_rgb, t_mbg, t_mh))


class PatchDiscriminator(nn.Module):
    """PatchGAN-4 (ndf 64): four stride-2 4x4 convs, then two stride-1 ones
    with padding 1, LeakyReLU(0.2), parameter-free InstanceNorm. NHWC in."""

    def __init__(self, input_nc, prec: Precision = FULL):
        super().__init__()
        ndf, layers, nf = 64, [Conv(input_nc, 64, 4, 2, 1, prec=prec), nn.LeakyReLU(0.2)], 1
        for n in range(1, 4):
            prev, nf = nf, min(2 ** n, 8)
            layers += [Conv(ndf * prev, ndf * nf, 4, 2, 1, prec=prec), InstanceNorm(ndf * nf, False),
                       nn.LeakyReLU(0.2)]
        prev, nf = nf, min(2 ** 4, 8)
        layers += [Conv(ndf * prev, ndf * nf, 4, 1, 1, prec=prec), InstanceNorm(ndf * nf, False),
                   nn.LeakyReLU(0.2), Conv(ndf * nf, 1, 4, 1, 1, prec=prec)]
        self.model = nn.Sequential(*layers)

    def forward(self, x):
        return self.model(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


_VGG = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512, 512, "M", 512)
_SLICES = (1, 3, 5, 9, 13)
VGG_WEIGHTS = (1.0 / 32, 1.0 / 16, 1.0 / 8, 1.0 / 4, 1.0)


class Vgg19(nn.Module):
    """VGG19's convolutions up to the 13th; the five slices after the ReLUs
    of convs 1, 3, 5, 9 and 13 (torchvision's `features` indices)."""

    def __init__(self, prec: Precision = FULL):
        super().__init__()
        layers, cin = [], 3
        for item in _VGG:
            if item == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [Conv(cin, item, 3, 1, 1, prec=prec), nn.ReLU()]
                cin = item
        self.features = nn.Sequential(*layers)
        self.requires_grad_(False)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        outs, n = [], 0
        for layer in self.features:
            x = layer(x)
            n += isinstance(layer, nn.Conv2d)
            if isinstance(layer, nn.ReLU) and n in _SLICES:
                outs.append(x)
        return outs


def build(cfg: dict, prec: Precision = FULL, device="meta") -> dict:
    """{"g", "d", "vgg"} as modules on `device` (shapes only on "meta")."""
    with torch.device(device):
        return dict(g=Generator(cfg, prec), d=PatchDiscriminator(cfg["d_input_nc"], prec),
                    vgg=Vgg19(prec))


def param_shapes(cfg: dict) -> dict:
    """{net: [(name, shape)]} in the order weights are drawn."""
    nets = build(cfg)
    return {k: [(n, tuple(p.shape)) for n, p in m.named_parameters()] for k, m in nets.items()}
