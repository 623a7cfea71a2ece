"""Model FLOPs of one training step or serving call, walked from the layer
geometry: every operation of the step counted once, as
`torch.utils.flop_counter.FlopCounterMode` counts a convolution or matrix
product (2 x MACs over the output grid, a transposed convolution over its
input grid, a backward as one forward per input or weight gradient it
computes), plus the hand-written combine kernels (one multiply-add per
pixel, channel and shift). Remat's recompute and the tensor-core kernels'
split passes are not counted: they change with the implementation, the
model does not.

A copy of the port's FLOP walk (`hoig_torch/utils/flops.py`, its "model"
count, held to FlopCounterMode on the card), kept here so that no change to
the program moves the yardstick. The conditioning's MANO and camera
products (about 2.4 MFLOP an image) and the rasterizer are left out.
"""

from __future__ import annotations

N_DOWN = 3
FC = 128
K2 = 25
COMBINE_ACC = 49  # the shift engine's combine over G's +-3 corner shifts
COMBINE_OUT = 121  # and over the source's +-5 shifts
_VGG = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512, 512, "M", 512)


def _out(s, k, stride=1, pad=0):
    return (s + 2 * pad - k) // stride + 1


def conv(b, h, w, cin, cout, k, gi, gw, train):
    """Forward plus, in training, one forward per gradient computed."""
    f = 2.0 * b * h * w * cin * cout * k * k
    return f * (1 + (gi + gw if train else 0))


def resnet(b, s, cin, cd, rep, t):
    tot = conv(b, s, s, cin, cd, 7, False, True, t)
    dim = cd
    for _ in range(N_DOWN):
        s = _out(s, 3, 2, 1)
        tot += conv(b, s, s, dim, dim * 2, 3, True, True, t)
        dim *= 2
    tot += 2 * rep * conv(b, s, s, dim, dim, 3, True, True, t)
    for _ in range(N_DOWN):
        tot += conv(b, s, s, dim, dim // 2, 3, True, True, t)
        dim, s = dim // 2, s * 2
    return tot + conv(b, s, s, dim, 3, 7, True, True, t)


def _spade(b, s, cond, nc, t):
    return (conv(b, s, s, cond, 128, 3, False, True, t)
            + 2 * conv(b, s, s, 128, nc, 3, True, True, t))


def resunet(b, s, cin, cond, cd, rep, on_obj, t):
    tot = conv(b, s, s, cin, cd, 7, False, True, t)
    dim = cd
    for _ in range(N_DOWN):
        s = _out(s, 3, 2, 1)
        tot += conv(b, s, s, dim, dim * 2, 3, True, True, t) + _spade(b, s, cond, dim * 2, t)
        dim *= 2
    for i in range(rep):
        tot += 2 * conv(b, s, s, dim, dim, 3, True, True, t)
        if i < rep // 2:
            tot += 2 * _spade(b, s, cond, dim, t)
    for _ in range(N_DOWN):
        tot += conv(b, s, s, dim, dim // 2, 3, True, True, t)
        dim, s = dim // 2, s * 2
        tot += conv(b, s, s, dim * 2, dim, 3, True, True, t)
    return tot + conv(b, s, s, cd if on_obj else 2 * cd, 3 if on_obj else 5, 7, True, True, t)


def attn_layers(s, cd, rep):
    out = [(s >> i, cd << i) for i in range(1, N_DOWN + 1)]
    return out + [out[-1]] * rep


def attention(b, s, c, engine, t):
    """The aten part of one flow-guided attention layer and its hand-written
    combines (shift engine: forward 2, backward 3 of them)."""
    n = b * s * s
    tot = conv(b, s, s, c, FC, 5, True, True, t)
    mm = lambda m, k, n_: 2.0 * m * k * n_ * (3 if t else 1)
    if engine == "shift":
        tot += conv(b, s + 6, s + 6, c, FC, 5, True, True, t) + mm(n, FC, K2)
        acc, out = 2.0 * n * FC * COMBINE_ACC, 2.0 * n * c * COMBINE_OUT
        tot += acc + out + ((acc + out + out) if t else 0.0)
    elif engine == "gather":
        tot += mm(n, c, 100 * FC) + mm(n, FC, K2)
    else:
        raise ValueError(f"the walk covers the shift and gather engines, not {engine!r}")
    return tot


def patchgan(b, s, cin, first_grad, grad_w, t):
    ndf, nf = 64, 1
    s = _out(s, 4, 2, 1)
    tot = conv(b, s, s, cin, ndf, 4, first_grad, grad_w, t)
    for n in range(1, 4):
        prev, nf = nf, min(2 ** n, 8)
        s = _out(s, 4, 2, 1)
        tot += conv(b, s, s, ndf * prev, ndf * nf, 4, True, grad_w, t)
    prev, nf = nf, 8
    s = _out(s, 4, 1, 1)
    tot += conv(b, s, s, ndf * prev, ndf * nf, 4, True, grad_w, t)
    s = _out(s, 4, 1, 1)
    return tot + conv(b, s, s, ndf * nf, 1, 4, True, grad_w, t)


def vgg19(b, s, grad_in, t):
    tot, cin = 0.0, 3
    for item in _VGG:
        if item == "M":
            s //= 2
        else:
            tot += conv(b, s, s, cin, item, 3, grad_in, False, t)
            cin = item
    return tot


def generator(cfg: dict, engine: str, b: int, t: bool) -> float:
    s, cd, rep = cfg["image_size"], cfg["conv_dim"], cfg["repeat_num"]
    return (resnet(2 * b, s, cfg["bg_dim"], cd, rep, t)
            + resunet(2 * b, s, cfg["obj_dim"], cfg["obj_cond_dim"], cd, rep, True, t)
            + 2 * resunet(b, s, cfg["img_dim"], cfg["img_cond_dim"], cd, rep, False, t)
            + sum(attention(b, h, c, engine, t) for h, c in attn_layers(s, cd, rep)))


def model_flops(cfg: dict, engine: str, b: int, kind: str) -> float:
    """Model FLOPs of one training step with D trained ("train": G, D in G's
    loss with input gradients, D's own step on the real and the fake, VGG19
    on the fake with input gradients and on the real without) or one serving
    call ("serve": the generator forward)."""
    if kind == "serve":
        return generator(cfg, engine, b, False)
    s, nc = cfg["image_size"], cfg["d_input_nc"]
    return (generator(cfg, engine, b, True)
            + patchgan(b, s, nc, True, False, True)
            + 2 * patchgan(b, s, nc, False, True, True)
            + vgg19(b, s, True, True) + vgg19(b, s, False, True))
