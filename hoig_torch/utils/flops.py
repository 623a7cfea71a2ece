"""FLOPs of the port's main path, walked from its layer geometry (the
counterpart of scripts/flops_ceiling.py's walk, counting the port's own
work: a stride-2 transposed convolution over its input grid, as cuDNN runs
it, not as a convolution at twice the resolution).

The walk splits the work as the card runs it:
  * the aten part, the convolutions and matrix products of the generator,
    PatchGAN-4 and VGG19 modules, counted as
    `torch.utils.flop_counter.FlopCounterMode` counts them (2 x MACs over
    the output grid, a transposed convolution over its input grid; a
    backward as one forward per input or weight gradient it computes);
  * the hand-written kernels, which FlopCounterMode cannot see (ctypes
    launches are no aten ops): per launch from their formulas
    (`combine_flops`, `fused_cost`), times the launches the path makes.
B2 (the rasterizer) is left out: its operations depend on the scene (the
pixel-face pairs its tile lists keep), and chip_smoke.py counts them from
the scene it runs. B3 only moves bytes. The conditioning's MANO and camera
einsums are left out as well (about 2.4 MFLOP an image).

"Model" FLOPs count each operation of the step once; "executed" FLOPs add
what the step runs again: the recompute of the rematerialized blocks, and
the second and third bf16 passes of the tensor-core gsrc projection and dW
(dG split into three bf16 parts).
"""

from __future__ import annotations

import dataclasses

# published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W): HBM3
# bytes/s, FP32 FLOP/s on the CUDA cores, bf16 and TF32 FLOP/s on the tensor
# cores (cuDNN runs f32 convolutions in TF32 unless torch is told otherwise)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_TC_FLOPS = 989e12
PEAK_TF32_TC_FLOPS = 494.7e12

N_DOWN = 3  # the generator's down / up stages (models/generator.py)
FC = 128  # ExtractorAttn's fc_0 width
K2 = 25  # its 5 x 5 window
# (kernel radius, coefficient columns) of the shift engine's two combines
# per layer: acc over the +-3 corner shifts of G, out over the +-5 shifts
COMBINE_ACC = (3, 49)
COMBINE_OUT = (5, 121)
_VGG_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512, 512, "M", 512)


@dataclasses.dataclass(frozen=True)
class Op:
    """One convolution or matrix product of a module: its forward FLOPs,
    its backward's in the training step (0 where it gets no gradient), and
    whether the step's remat recomputes it."""

    fwd: float
    bwd: float = 0.0
    remat: bool = False


def conv_out(size: int, k: int, stride: int = 1, pad: int = 0) -> int:
    return (size + 2 * pad - k) // stride + 1


def conv(b: int, h: int, w: int, cin: int, cout: int, k: int, grad_in: bool, grad_w: bool,
         remat: bool = False) -> Op:
    """A k x k convolution with an (h, w) output grid (for a transposed one,
    its input grid)."""
    f = 2.0 * b * h * w * cin * cout * k * k
    return Op(f, f * (grad_in + grad_w), remat)


def mm(m: int, k: int, n: int, grad_in: bool, grad_w: bool, remat: bool = False) -> Op:
    f = 2.0 * m * k * n
    return Op(f, f * (grad_in + grad_w), remat)


def _square_conv(b, s, cin, cout, k, stride, pad, gi, gw, remat):
    o = conv_out(s, k, stride, pad)
    return conv(b, o, o, cin, cout, k, gi, gw, remat), o


def resnet_ops(b: int, s: int, cin: int, cd: int, repeat: int, remat: bool,
               remat_mid: bool) -> list:
    """ResNetGenerator (the background branch)."""
    ops = [conv(b, s, s, cin, cd, 7, False, True, remat)]
    dim = cd
    for _ in range(N_DOWN):
        op, s = _square_conv(b, s, dim, dim * 2, 3, 2, 1, True, True, remat)
        ops.append(op)
        dim *= 2
    ops += [conv(b, s, s, dim, dim, 3, True, True, remat_mid) for _ in range(2 * repeat)]
    for _ in range(N_DOWN):
        ops.append(conv(b, s, s, dim, dim // 2, 3, True, True, remat))  # transposed, input grid
        dim, s = dim // 2, s * 2
    ops.append(conv(b, s, s, dim, 3, 7, True, True))
    return ops


def _spade(b, s, cond, nc, remat):
    """SPADE's three convolutions at the feature's grid; the condition map
    is data (no input gradient)."""
    return [conv(b, s, s, cond, 128, 3, False, True, remat),
            conv(b, s, s, 128, nc, 3, True, True, remat),
            conv(b, s, s, 128, nc, 3, True, True, remat)]


def resunet_ops(b: int, s: int, cin: int, cond: int, cd: int, repeat: int, on_obj: bool,
                remat: bool, remat_mid: bool) -> list:
    """ResUnetGenerator with spade_layers (1, 1, 0, 0): SPADE in the encoder
    and in the first half of the bottleneck; its heads (for a hand branch,
    the one 7x7 convolution over [x, y] to 5 channels that
    ResUnetGenerator.regress runs, y being the object branch's features)."""
    ops = [conv(b, s, s, cin, cd, 7, False, True, remat)]
    dim = cd
    for _ in range(N_DOWN):
        op, s = _square_conv(b, s, dim, dim * 2, 3, 2, 1, True, True, remat)
        ops += [op] + _spade(b, s, cond, dim * 2, remat)
        dim *= 2
    for i in range(repeat):
        spade = i < repeat // 2
        # a checkpoint's recompute stops at the last tensor the block saved:
        # an op saves its inputs before it runs, and a SPADE residual
        # block's conv_1 is its last op that saves anything
        ops += [conv(b, s, s, dim, dim, 3, True, True, remat_mid),
                conv(b, s, s, dim, dim, 3, True, True, remat_mid and not spade)]
        if spade:
            ops += _spade(b, s, cond, dim, remat_mid) + _spade(b, s, cond, dim, remat_mid)
    for _ in range(N_DOWN):
        ops.append(conv(b, s, s, dim, dim // 2, 3, True, True, remat))  # transposed, input grid
        dim, s = dim // 2, s * 2
        ops.append(conv(b, s, s, dim * 2, dim, 3, True, True, remat))  # skipper on cat(skip, x)
    if on_obj:
        ops.append(conv(b, s, s, cd, 3, 7, True, True))
    else:
        ops.append(conv(b, s, s, 2 * cd, 5, 7, True, True))
    return ops


def attn_layers(s: int, cd: int, repeat: int) -> list:
    """(grid, channels) of the 9 lockstep attention layers (n_down + repeat)."""
    out = [(s >> i, cd << i) for i in range(1, N_DOWN + 1)]
    return out + [out[-1]] * repeat


def attn_ops(b: int, s: int, c: int, engine: str, remat: bool) -> list:
    """The aten part of one ExtractorAttn: fc_0's target half (a VALID 5x5
    convolution of the edge-padded target), then per engine: shift, fc_0's
    source half as one 5x5 convolution over the (s+6)^2 halo grid and fc_1
    as a matrix product; gather, the source half as the 36 corner products
    (each of the 25 offsets reads 4 corners: 100 x 128 columns) and fc_1;
    pallas, nothing more forward (B4-fwd runs the rest), fc_1's two
    backward products in plain tensor code."""
    n = b * s * s
    ops = [conv(b, s, s, c, FC, 5, True, True, remat)]
    if engine == "shift":
        ops += [conv(b, s + 6, s + 6, c, FC, 5, True, True, remat),
                mm(n, FC, K2, True, True, remat)]
    elif engine == "gather":
        ops += [mm(n, c, 100 * FC, True, True, remat), mm(n, FC, K2, True, True, remat)]
    elif engine == "pallas":
        ops.append(Op(0.0, 2 * 2.0 * n * FC * K2))
    else:
        raise ValueError(f"unknown corner engine {engine!r}")
    return ops


def patchgan_ops(b: int, s: int, cin: int, first_grad: bool = False, grad_w: bool = True) -> list:
    """PatchGAN-4 (build_networks: ndf 64, n_layers 4): four stride-2 4x4
    convolutions, then two stride-1 4x4 ones with padding 1 (each shrinks
    the grid by one)."""
    ndf, n_layers = 64, 4
    ops, nf = [], 1
    op, s = _square_conv(b, s, cin, ndf, 4, 2, 1, first_grad, grad_w, False)
    ops.append(op)
    for n in range(1, n_layers):
        prev, nf = nf, min(2 ** n, 8)
        op, s = _square_conv(b, s, ndf * prev, ndf * nf, 4, 2, 1, True, grad_w, False)
        ops.append(op)
    prev, nf = nf, min(2 ** n_layers, 8)
    op, s = _square_conv(b, s, ndf * prev, ndf * nf, 4, 1, 1, True, grad_w, False)
    ops.append(op)
    op, s = _square_conv(b, s, ndf * nf, 1, 4, 1, 1, True, grad_w, False)
    return ops + [op]


def vgg19_ops(b: int, s: int, grad_in: bool, remat: bool = False) -> list:
    """Vgg19Features: VGG19's convolutions up to the 13th (the five loss
    slices end there), frozen weights."""
    ops, cin = [], 3
    for item in _VGG_CFG:
        if item == "M":
            s //= 2
        else:
            ops.append(conv(b, s, s, cin, item, 3, grad_in, False, remat))
            cin = item
    return ops


def generator_ops(cfg, b: int) -> dict:
    """{subnet: [Op]} of generator_spade_attn's forward at batch b (the
    background and object branches run at 2b)."""
    if cfg.gen_name != "generator_spade_attn" or not cfg.use_spade:
        raise ValueError(f"the walk covers generator_spade_attn with SPADE, not {cfg.gen_name}")
    s, cd, rep = cfg.image_size, cfg.conv_dim, cfg.repeat_num
    remat, mid = cfg.remat, cfg.remat and cfg.remat_bottleneck
    ra = cfg.remat and cfg.remat_attn
    return {
        "bg (ResNet, 2B)": resnet_ops(2 * b, s, cfg.bg_dim, cd, rep, remat, mid),
        "obj (ResUnet, 2B)": resunet_ops(2 * b, s, cfg.obj_dim, cfg.obj_cond_dim, cd, rep, True,
                                         remat, mid),
        "src hand (ResUnet)": resunet_ops(b, s, cfg.img_dim, cfg.img_cond_dim, cd, rep, False,
                                          remat, mid),
        "tsf hand (ResUnet)": resunet_ops(b, s, cfg.img_dim, cfg.img_cond_dim, cd, rep, False,
                                          remat, mid),
        "attention x%d (aten part)" % (N_DOWN + rep): [
            op for h, c in attn_layers(s, cd, rep) for op in attn_ops(b, h, c, cfg.corner_engine, ra)],
    }


def step_ops(cfg, b: int) -> dict:
    """{subnet: [Op]} of one training step with D trained (make_train_step):
    the generator; D on the fake in G's loss (input gradients only); D's
    own step on the real and the detached fake (weight gradients, no
    gradient into its input); VGG19 on the fake (input gradients) and on the
    real (no gradient), both recomputed under remat with the generator."""
    if not cfg.use_vgg:
        raise ValueError("the walk covers the step with the VGG loss (use_vgg)")
    ops = generator_ops(cfg, b)
    s, nc = cfg.image_size, cfg.d_input_nc
    ops["D in G's loss (fake)"] = patchgan_ops(b, s, nc, first_grad=True, grad_w=False)
    ops["D step (real + fake)"] = 2 * patchgan_ops(b, s, nc)
    ops["VGG19 (fake + real)"] = (vgg19_ops(b, s, True, cfg.remat)
                                  + vgg19_ops(b, s, False, cfg.remat))
    return ops


def serving_ops(cfg, b: int) -> dict:
    """{subnet: [Op]} of one serving call (forward_only: no gradient, no remat)."""
    return {k: [Op(op.fwd) for op in v] for k, v in generator_ops(cfg, b).items()}


def totals(ops: list) -> dict:
    model = sum(op.fwd + op.bwd for op in ops)
    return dict(model=model, executed=model + sum(op.fwd for op in ops if op.remat))


# ----------------------------------------------------------- hand kernels


def combine_flops(b: int, h: int, w: int, c: int, k2: int) -> float:
    """B1 (forward, bwd_src or bwd_v) over (b, h, w, c) and k2 shifts: one
    multiply-add per pixel, channel and shift."""
    return 2.0 * b * h * w * c * k2


def fused_cost(name: str, b: int, h: int, w: int, c: int, bf16: bool) -> tuple:
    """(bytes, FP32 operations, bf16 tensor-core operations) of one B4
    launch of wrapper `name` on a (b, h, w, c) layer: each input read once,
    each output written once (dG is an output of bwd-a-gsrc and an input of
    dW); the coefficient terms only where nonzero (4 of 49 for acc and dG,
    36 of 121 per pixel for phase C and bwd-c). Each 5x5 product is counted
    over the (h+6) x (w+6) frame of G or dG: the forward needs G only
    there, and dG is zero outside it, so the gsrc projection and dW pair
    each of its pixels with the 25 offsets once. Under bf16 the three
    products run on the tensor cores, the gsrc one and dW as three bf16
    passes (dG split into hi + mid + lo): JAX's f32 product."""
    es = 2 if bf16 else 4
    n = b * h * w
    n_halo = b * (h + 6) * (w + 6)
    fields = 4 * n * 4
    conv_halo = 2.0 * n_halo * K2 * c * FC
    if name == "attn_fused_fwd":
        nbytes = (2 * n * c + K2 * c * FC) * es + (2 * n * FC + n * K2 + FC * K2 + K2) * 4 + fields
        f32_ops = 2.0 * n * (4 * FC + FC * K2 + 36 * c)
        return nbytes, f32_ops + (0.0 if bf16 else conv_halo), conv_halo if bf16 else 0.0
    if name == "attn_fused_bwd_c":
        nbytes = 2 * n * c * es + (n * c + 2 * n * K2) * 4 + fields
        return nbytes, 2.0 * n * 36 * c * 2, 0.0
    if name == "attn_fused_bwd_a_gsrc":
        nbytes = K2 * c * FC * es + (n * FC + n * c + n_halo * FC) * 4 + fields
        dg_ops = 2.0 * n * 4 * FC
        return (nbytes, dg_ops, 3 * conv_halo) if bf16 else (nbytes, dg_ops + conv_halo, 0.0)
    if name == "attn_fused_bwd_a_dw":
        nbytes = n * c * es + (n_halo * FC + K2 * c * FC) * 4
        return (nbytes, 0.0, 3 * conv_halo) if bf16 else (nbytes, conv_halo, 0.0)
    raise ValueError(f"unknown B4 wrapper {name!r}")


def _fused_model(name: str, b: int, h: int, w: int, c: int, bf16: bool) -> float:
    """fused_cost's operations with each product counted once."""
    _, f32, tc = fused_cost(name, b, h, w, c, bf16)
    if bf16 and name in ("attn_fused_bwd_a_gsrc", "attn_fused_bwd_a_dw"):
        tc /= 3
    return f32 + tc


def kernel_launches(cfg, b: int, leg: str) -> dict:
    """{counter: [(model FLOPs, executed FLOPs) of each launch]} of the
    hand-written attention kernels on one serving call (leg "serve") or one
    training step ("train"), under the launch counters' names (`_tc` where
    bf16 takes the tensor-core entry point). The recompute of remat_attn
    runs each layer's forward again: model 0, executed as the forward."""
    import torch

    bf16 = cfg.compute_dtype == torch.bfloat16
    train = leg == "train"
    recompute = train and cfg.remat and cfg.remat_attn
    tc = "_tc" if bf16 else ""
    out: dict = {}

    def add(counter, flops, model=True):
        out.setdefault(counter, []).append((flops if model else 0.0, flops))

    for h, c in attn_layers(cfg.image_size, cfg.conv_dim, cfg.repeat_num):
        if cfg.corner_engine == "shift":
            fwd = ((combine_flops(b, h, h, FC, COMBINE_ACC[1]),
                    combine_flops(b, h, h, c, COMBINE_OUT[1])))
            for f in fwd:
                add("local_combine" + tc, f)
                if recompute:
                    add("local_combine" + tc, f, model=False)
            if train:
                for f in fwd:
                    add("local_combine_bwd_src" + tc, f)
                add("local_combine_bwd_v" + tc, fwd[1])
        elif cfg.corner_engine == "pallas":
            names = ("attn_fused_fwd",) + (
                ("attn_fused_bwd_c", "attn_fused_bwd_a_gsrc", "attn_fused_bwd_a_dw") if train else ())
            for name in names:
                counter = name + ("" if name == "attn_fused_bwd_c" else tc)
                model = _fused_model(name, b, h, h, c, bf16)
                executed = sum(fused_cost(name, b, h, h, c, bf16)[1:])
                out.setdefault(counter, []).append((model, executed))
                if name == "attn_fused_fwd" and recompute:
                    out[counter].append((0.0, executed))
    return out


def edge_pad_folds(cfg, leg: str) -> int:
    """Launches of the edge-pad fold (a data-movement kernel, outside the
    FLOP walk) in one serving call (none: no backward) or training step: one
    per attention layer for the fc_0 target half's pad, and one more for the
    shift engine's padded source."""
    if leg != "train":
        return 0
    per_layer = 2 if cfg.corner_engine == "shift" else 1
    return per_layer * len(attn_layers(cfg.image_size, cfg.conv_dim, cfg.repeat_num))


def scatter_rows_launches(cfg, leg: str) -> int:
    """Launches of scatter_rows (a data-movement kernel, outside the FLOP
    walk) in one serving call (none: no backward) or training step: the
    gather engine's one corner gather per attention layer transposes once."""
    if leg != "train" or cfg.corner_engine != "gather":
        return 0
    return len(attn_layers(cfg.image_size, cfg.conv_dim, cfg.repeat_num))


def leg_flops(cfg, b: int, leg: str) -> dict:
    """FLOPs of one serving call ("serve") or training step ("train") at
    batch b: {"aten": {subnet: {model, executed}}, "kernels": {counter:
    {launches, model, executed}}, "total": {model, executed}}."""
    ops = step_ops(cfg, b) if leg == "train" else serving_ops(cfg, b)
    aten = {k: totals(v) for k, v in ops.items()}
    kernels = {k: dict(launches=len(v), model=sum(m for m, _ in v), executed=sum(e for _, e in v))
               for k, v in kernel_launches(cfg, b, leg).items()}
    total = {key: sum(v[key] for v in aten.values()) + sum(v[key] for v in kernels.values())
             for key in ("model", "executed")}
    return dict(aten=aten, kernels=kernels, total=total)


def aten_flops(fn) -> tuple:
    """(fn(), the FLOPs FlopCounterMode counts while it runs)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        out = fn()
    return out, counter.get_total_flops()
