"""Fused flow-guided local attention for k = 5, forward and backward
(counterpart of hoig_tpu/ops/attn_pallas.py).

The whole `ExtractorAttn` of one layer under the HOGAN flow bound
(floor(flow) in [-3, 2] per axis, so every bilinear corner is a bounded
integer shift of the source):

  phase A  G[q] = sum_t src_pad[q + t] @ W_t        (5x5 correlation, C -> 128)
           acc[p] = acc0[p] + sum_e Cyx[e][p] * G[p + e]     (e in [-3, 3]^2)
  phase B  attn = softmax(leaky_relu(acc) @ w1 + b1)  (128 -> 25, f32)
  phase C  out[p] = (1/25) sum_d V_d[p] * src_pad[p + d],  d in [-5, 5]^2,
           V_d = sum_e Cyx[e] * attn_{d - e}  (built separably, x then y)

with Cyx[e] = ay[ey] * ax[ex] the per-axis bilinear coefficient fields and
src_pad the source edge-padded by PAD = 5. `flow_attention_fused` is the
autograd Function `FlowAttentionFused`: its forward keeps acc and attn as
residuals; its backward runs the phase-C backward (`attn_fused_bwd_c`),
phase B's backward in plain tensor code (as the JAX package does), then the
phase-A backward: `attn_fused_bwd_a_gsrc` builds dG, the gradient of G on
the +-3 halo, projects it onto the source and returns it, and
`attn_fused_bwd_a_dw` takes that dG for dW (dG is built once per backward;
the two TPU kernels each built their own).

Each of the four wrappers runs its plain PyTorch version (`*_reference`)
for CPU tensors and, for CUDA tensors, launches its entry point of
csrc/attn_fused.cu or raises. B4-fwd, B4-bwd-a-gsrc and B4-bwd-a-dw have
two entry points each, chosen by dtype: bf16 runs their 5x5 product on the
tensor cores (`hoig_attn_fused_fwd_tc`, `hoig_attn_fused_bwd_a_gsrc_tc`,
`hoig_attn_fused_bwd_a_dw_tc`, counted as `attn_fused_fwd_tc`,
`attn_fused_bwd_a_gsrc_tc` and `attn_fused_bwd_a_dw_tc`), f32 as FP32 on
the CUDA cores (`hoig_attn_fused_fwd`, `hoig_attn_fused_bwd_a_gsrc`,
`hoig_attn_fused_bwd_a_dw`, counted under their own names). The gsrc
projection's and dW's tensor-core forms split the f32 dG into three bf16
parts (`split_bf16x3`) whose products with the bf16 weights or source are
exact in f32. The plain versions follow the TPU kernels'
precision: phase-A products from the input dtype with f32 sums; the
coefficient fields, the residuals and the softmax in f32; the phase-C and
bwd-c products in the source dtype (rounded there, as bf16 * bf16 is in
JAX) with f32 sums; one cast at the end. Their elementwise parts (the
coefficient fields, the V build, every weighted-shift sum, dG, the margin
folds) fix an order of summation that the CUDA kernels repeat; only the
channel reductions (G, the logits, the g_attn dots, the gsrc_a projection
and dW) are summed in another order on the card.

B4-bwd-c is one pass over the frame on the card (`bwd_c_kernel`, a block
per image, 8 x 8 tile and 64 channels: V and the padded source gradient
stay in shared memory and registers) and a small second launch that adds
the channel groups' partial g_attn dots in order (`bwd_c_gattn_kernel`).

The edge-padded margins of the source gradient are folded onto the border
pixels (the replicate-pad backward) by `_fold_edges` here, and on the card
by `bwd_c_kernel` in its tiles and by `fold_kernel` for the gsrc
projection, all in the same order: the margin columns of a row in
ascending order first, then the rows. The generator's own replicate pads
(`edge_pad`) fold their gradient in that order too (`edge_pad_fold`, one
fold_kernel launch on the card).

An odd channel count runs through each wrapper at the next even count
(`with_even_channels`): the kernels tile channel pairs.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F_
from torch.autograd.function import once_differentiable

from hoig_torch.ops import _cuda

K = 5  # kernel size: the only value the HOGAN family uses
R = K // 2
FLOOR_LO, FLOOR_HI = -3, 2  # floor(flow) bounds per axis
EY_LO, EY_HI = FLOOR_LO, FLOOR_HI + 1  # corner-shift range per axis: -3..3
HALO = EY_HI  # G is needed on the +-3 neighbourhood of the image
PAD = R + FLOOR_HI + 1  # 5: largest total shift per axis
NSHIFT = 2 * PAD + 1  # 11 total shifts per axis
F = 128  # fc_0 hidden width
K2 = K * K
_NE = EY_HI - EY_LO + 1  # 7 coefficient shifts per axis

_P = ctypes.c_void_p
_I = ctypes.c_int
# fwd: src, acc0, w0s, w1, b1, fy, fx, wy, wx, out, acc, attn, g_scratch, b, h, w, c, bf16, stream
# (fwd, bwd_a_gsrc and bwd_a_dw refuse bf16 = 1: bf16 takes their _tc entry points)
_FWD_ARGS = [_P] * 13 + [_I] * 5 + [_P]
# bwd_c: src, fy, fx, wy, wx, attn, g_out, gsrc, g_attn, dot_scratch, b, h, w, c, groups, bf16, stream
_BWD_C_ARGS = [_P] * 10 + [_I] * 6 + [_P]
# fwd_tc: as fwd with part_scratch after g_scratch, and splits in place of bf16
_FWD_TC_ARGS = [_P] * 14 + [_I] * 5 + [_P]
# bwd_a_gsrc: g_acc, fy, fx, wy, wx, w0s, gsrc, dg, pad_scratch, b, h, w, c, bf16, stream
_BWD_A_GSRC_ARGS = [_P] * 9 + [_I] * 5 + [_P]
# bwd_a_gsrc_tc: as bwd_a_gsrc with part_scratch after pad_scratch, and splits in place of bf16
_BWD_A_GSRC_TC_ARGS = [_P] * 10 + [_I] * 5 + [_P]
# bwd_a_dw: src, dg, dw, part_scratch, b, h, w, c, slices, bf16, stream
_BWD_A_DW_ARGS = [_P] * 4 + [_I] * 6 + [_P]
# bwd_a_dw_tc: src, dg, dw, part_scratch, b, h, w, c, splits, stream
_BWD_A_DW_TC_ARGS = [_P] * 4 + [_I] * 5 + [_P]
# edge_pad_fold: gpad, out, b, h, w, c, p, bf16, stream
_EDGE_PAD_FOLD_ARGS = [_P] * 2 + [_I] * 6 + [_P]
_SMS = 132  # the H100's SMs: the split-K factors aim at filling them
# the kernels' tile constants that the split-K factors count, in the order
# in which attn_fused.cu's hoig_attn_fused_tiling reports them (chip_smoke.py
# holds this copy against it): conv5_tc_kernel's output tiles of 8 x 8
# pixels, two per block, 128 outputs wide; dw_tc_kernel's chunks of 64
# pixels and 128 channels per block; dw_kernel's 64 channels per block;
# bwd_c_kernel's 8 x 8 tiles and 64 channels per block (its channel groups,
# which the entry point checks)
TILING = dict(tc_tile=8, tc_tiles_per_block=2, tc_n=128, dw_tc_pixels=64, dw_tc_channels=128,
              dw_channels=64, bwd_c_tile=8, bwd_c_channels=64)
BOX = 36  # V_d that can be nonzero per pixel: the 6 x 6 box of d at its relative floor


def _offsets():
    return [(ty, tx) for ty in range(-R, R + 1) for tx in range(-R, R + 1)]


def flow_fields(flow: torch.Tensor):
    """Per-pixel relative floors (clipped to the bounded range, exact small
    integers in f32) and bilinear fractions of a (B, H, W, 2) pixel-unit
    flow: (fy_rel, fx_rel, wy, wx), each (B, H, W) f32."""
    f32 = torch.float32
    b, h, w = flow.shape[:3]
    xf = torch.arange(w, dtype=f32, device=flow.device)[None, :].expand(h, w)
    yf = torch.arange(h, dtype=f32, device=flow.device)[:, None].expand(h, w)
    fx = flow[..., 0].to(f32) + xf
    fy = flow[..., 1].to(f32) + yf
    x0, y0 = fx.floor(), fy.floor()
    fx_rel = (x0 - xf).clamp(FLOOR_LO, FLOOR_HI).contiguous()
    fy_rel = (y0 - yf).clamp(FLOOR_LO, FLOOR_HI).contiguous()
    return fy_rel, fx_rel, (fy - y0).contiguous(), (fx - x0).contiguous()


def coeff_axes(fy_rel, fx_rel, wy, wx):
    """Per-axis bilinear coefficient fields: lists ay, ax of 7 (B, H, W) f32
    fields for the integer shifts e = -3..3 (index e + 3). A sample with
    floor f and fraction w puts (1 - w) on shift f and w on shift f + 1."""
    def axis(f_rel, wgt):
        out = []
        for e in range(EY_LO, EY_HI + 1):
            a = torch.zeros_like(wgt)
            if FLOOR_LO <= e <= FLOOR_HI:
                a = torch.where(f_rel == e, 1.0 - wgt, a)
            if FLOOR_LO <= e - 1 <= FLOOR_HI:
                a = torch.where(f_rel == e - 1, wgt, a)
            out.append(a)
        return out

    return axis(fy_rel, wy), axis(fx_rel, wx)


def v_fields(attn: torch.Tensor, ay, ax) -> torch.Tensor:
    """V_(dy, dx) = sum_e Cyx[e] attn_(d - e), (B, H, W, 11, 11) f32, built
    separably: Vx[ty, dx] = sum_ex ax[ex] attn[ty, dx - ex] (ascending ex),
    then V[dy, dx] = sum_ey ay[ey] Vx[dy - ey, dx] (ascending ey)."""
    b, h, w = attn.shape[:3]
    attn5 = attn.reshape(b, h, w, K, K)
    vx = attn.new_zeros((b, h, w, K, NSHIFT))
    for exi in range(_NE):
        vx[..., :, exi:exi + K] += ax[exi][..., None, None] * attn5
    v = attn.new_zeros((b, h, w, NSHIFT, NSHIFT))
    for eyi in range(_NE):
        v[..., eyi:eyi + K, :] += ay[eyi][..., None, None] * vx
    return v


def _edge_pad_copy(x: torch.Tensor, p: int) -> torch.Tensor:
    h, w = x.shape[1], x.shape[2]
    rows = torch.arange(-p, h + p, device=x.device).clamp(0, h - 1)
    cols = torch.arange(-p, w + p, device=x.device).clamp(0, w - 1)
    return x.index_select(1, rows).index_select(2, cols)


class _EdgePad(torch.autograd.Function):
    """The replicate pad with a backward that folds in a fixed order
    (`edge_pad_fold`): index_select's own backward adds the margins with
    float atomics on the card, in no fixed order."""

    @staticmethod
    def forward(ctx, x, p: int):
        ctx.p = p
        return _edge_pad_copy(x, p)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return edge_pad_fold(g.contiguous(), ctx.p), None


def edge_pad(x: torch.Tensor, p: int) -> torch.Tensor:
    """Replicate-pad the two spatial axes of an NHWC tensor by p: an exact
    copy forward; backward, each border pixel collects its margin's
    gradient (`edge_pad_fold`), the same bits on every run."""
    return _EdgePad.apply(x, p)


def _fold_axis(x: torch.Tensor, axis: int, p: int) -> torch.Tensor:
    """Fold the p margin entries on each side of `axis` onto its border
    entries, adding in ascending order along the axis."""
    n = x.shape[axis] - 2 * p
    first = x.narrow(axis, 0, 1)
    for j in range(1, p + 1 + (p if n == 1 else 0)):
        first = first + x.narrow(axis, j, 1)
    if n == 1:
        return first
    last = x.narrow(axis, p + n - 1, 1)
    for j in range(p + n, n + 2 * p):
        last = last + x.narrow(axis, j, 1)
    return torch.cat([first, x.narrow(axis, p + 1, n - 2), last], dim=axis)


def _fold_edges(gpad: torch.Tensor, p: int = PAD) -> torch.Tensor:
    """Gradient of the edge-padded frame (B, H+2p, W+2p, C) -> of the image
    (B, H, W, C): columns first, then rows."""
    return _fold_axis(_fold_axis(gpad, 2, p), 1, p)


def edge_pad_fold_reference(gpad: torch.Tensor, p: int) -> torch.Tensor:
    """The replicate pad's backward, plain: `_fold_edges` of the f32
    gradient, rounded once to its dtype (the kernel's arithmetic)."""
    return _fold_edges(gpad.float(), p).to(gpad.dtype)


def edge_pad_fold(gpad: torch.Tensor, p: int) -> torch.Tensor:
    """The gradient of an edge-padded NHWC frame (B, H+2p, W+2p, C), f32 or
    bf16, folded onto the image (B, H, W, C) in its dtype: the plain version
    on the CPU; on the card one launch of fold_kernel (entry point
    `hoig_edge_pad_fold`, counted as `edge_pad_fold`), bit-equal to it."""
    if gpad.device.type == "cpu":
        return edge_pad_fold_reference(gpad, p)
    _cuda.require_cuda(gpad)
    if gpad.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"edge_pad_fold takes f32 or bf16, got {gpad.dtype}")
    if gpad.dim() != 4 or not gpad.is_contiguous():
        raise ValueError(f"edge_pad_fold takes a contiguous (B, H, W, C) frame, got "
                         f"{tuple(gpad.shape)}")
    b, hp, wp, c = gpad.shape
    h, w = hp - 2 * p, wp - 2 * p
    if p < 0 or h < 1 or w < 1 or b < 1 or c < 1:
        raise ValueError(f"edge_pad_fold: frame {tuple(gpad.shape)} with pad {p}")
    out = torch.empty((b, h, w, c), dtype=gpad.dtype, device=gpad.device)
    _launch("hoig_edge_pad_fold", "edge_pad_fold", _EDGE_PAD_FOLD_ARGS,
            _ptrs(gpad, out) + [b, h, w, c, p, int(gpad.dtype == torch.bfloat16)])
    return out


def _conv_weight(w0s: torch.Tensor) -> torch.Tensor:
    """(25, C, 128) offset-major source-half weights -> (128, C, 5, 5) f32."""
    c = w0s.shape[1]
    return w0s.float().reshape(K, K, c, F).permute(3, 2, 0, 1)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _div25(x: torch.Tensor) -> torch.Tensor:
    """x / 25, rounded as an IEEE division on both devices (torch's CUDA
    division by a Python scalar multiplies by its reciprocal instead)."""
    return x / torch.full((), float(K2), dtype=x.dtype, device=x.device)


def _product(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A coefficient field times a tensor, the product rounded in x's dtype
    (bf16 * bf16 under bf16), returned in f32 for the sum."""
    return (v[..., None].to(x.dtype) * x).float()


def split_bf16x3(x: torch.Tensor):
    """x (f32) as three bf16 tensors with hi + mid + lo == x exactly, the
    split the gsrc projection's tensor-core kernel makes of dG when it stages
    it (csrc/attn_fused.cu, split3): hi keeps x's top 16 bits (a truncation,
    which never rounds past the bf16 range), mid the top 16 bits of the
    exact remainder x - hi, lo the rest. The rest has at most 8 significant
    bits, so it is a bf16 itself wherever x's lowest bit is not below bf16's
    smallest subnormal 2^-133 (every |x| >= 2^-110); below that lo drops
    what lies under 2^-133."""
    def top16(v):
        return (v.view(torch.int32) & -65536).view(torch.float32)

    x = x.float()
    hi = top16(x)
    r1 = x - hi
    mid = top16(r1)
    lo = top16(r1 - mid)
    return hi.to(torch.bfloat16), mid.to(torch.bfloat16), lo.to(torch.bfloat16)


# ------------------------------------------------------------ plain versions


@torch.no_grad()
def attn_fused_fwd_reference(src, acc0, w0s, w1, b1, fy_rel, fx_rel, wy, wx):
    """B4-fwd, plain: (out in src's dtype, acc f32, attn f32)."""
    b, h, w, c = src.shape
    src_pad = edge_pad(src, PAD)
    # phase A: the products of two values of the input dtype are exact in f32
    g = _nhwc(F_.conv2d(_nchw(src_pad.float()), _conv_weight(w0s)))  # (B, H+6, W+6, F)
    ay, ax = coeff_axes(fy_rel, fx_rel, wy, wx)
    acc = acc0.float()
    for eyi in range(_NE):
        for exi in range(_NE):
            acc = acc + (ay[eyi] * ax[exi])[..., None] * g[:, eyi:eyi + h, exi:exi + w, :]
    # phase B
    hdn = torch.where(acc >= 0, acc, 0.01 * acc)
    attn = torch.softmax(hdn @ w1.float() + b1.float()[0], dim=-1)
    # phase C
    v = v_fields(attn, ay, ax)
    out = torch.zeros((b, h, w, c), dtype=torch.float32, device=src.device)
    for dy in range(NSHIFT):
        for dx in range(NSHIFT):
            out += _product(v[..., dy, dx], src_pad[:, dy:dy + h, dx:dx + w, :])
    return _div25(out).to(src.dtype), acc, attn


@torch.no_grad()
def attn_fused_bwd_c_reference(src, fy_rel, fx_rel, wy, wx, attn, g_out):
    """B4-bwd-c, plain: (gsrc_c f32 (B, H, W, C), g_attn f32 (B, H, W, 25))."""
    b, h, w, c = src.shape
    g = g_out.to(src.dtype)
    src_pad = edge_pad(src, PAD)
    ay, ax = coeff_axes(fy_rel, fx_rel, wy, wx)
    v = v_fields(attn.float(), ay, ax)
    gpad = torch.zeros((b, h + 2 * PAD, w + 2 * PAD, c), dtype=torch.float32, device=src.device)
    for dy in range(NSHIFT):
        for dx in range(NSHIFT):
            gpad[:, dy:dy + h, dx:dx + w, :] += _product(v[..., dy, dx], g)
    gsrc = _div25(_fold_edges(gpad))
    # g_attn_t = (1/25) sum_e Cyx[e] <g_out[p], src_pad[p + t + e]>, separably
    sdot = src.new_zeros((b, h, w, NSHIFT, NSHIFT), dtype=torch.float32)
    for dy in range(NSHIFT):
        for dx in range(NSHIFT):
            sdot[..., dy, dx] = (g * src_pad[:, dy:dy + h, dx:dx + w, :]).float().sum(-1)
    sx = sdot.new_zeros((b, h, w, NSHIFT, K))
    for exi in range(_NE):
        sx += ax[exi][..., None, None] * sdot[..., :, exi:exi + K]
    ga = sdot.new_zeros((b, h, w, K, K))
    for eyi in range(_NE):
        ga += ay[eyi][..., None, None] * sx[..., eyi:eyi + K, :]
    return gsrc, _div25(ga.reshape(b, h, w, K2))


def _dg_reference(g_acc, ay, ax):
    """dG[q] = sum_e (Cyx[e] g_acc)[q - e] on the +-3 halo, (B, H+6, W+6, F)."""
    b, h, w, _ = g_acc.shape
    dg = g_acc.new_zeros((b, h + 2 * HALO, w + 2 * HALO, F), dtype=torch.float32)
    for eyi in range(_NE):
        for exi in range(_NE):
            dg[:, eyi:eyi + h, exi:exi + w, :] += (ay[eyi] * ax[exi])[..., None] * g_acc.float()
    return dg


@torch.no_grad()
def attn_fused_bwd_a_gsrc_reference(g_acc, fy_rel, fx_rel, wy, wx, w0s):
    """B4-bwd-a-gsrc, plain: (the fc_0 half of the source gradient
    (B, H, W, C) f32, dG (B, H+6, W+6, 128) f32, which dW takes)."""
    dg = _dg_reference(g_acc, *coeff_axes(fy_rel, fx_rel, wy, wx))
    gpad = _nhwc(F_.conv_transpose2d(_nchw(dg), _conv_weight(w0s)))  # (B, H+10, W+10, C)
    return _fold_edges(gpad), dg


@torch.no_grad()
def attn_fused_bwd_a_dw_reference(src, dg):
    """B4-bwd-a-dw, plain: dW_t = sum over every padded pixel m of the batch
    of src_pad[m] (x) dG[m - 2 - t], (25, C, 128) f32, from the source and
    the dG of attn_fused_bwd_a_gsrc."""
    b, h, w, c = src.shape
    # dG read at m - 2 - t on the padded frame: zero-extend the halo frame by 4
    dgp = F_.pad(dg, (0, 0, 4, 4, 4, 4))
    src_m = edge_pad(src, PAD).float().reshape(-1, c).t()
    hp, wp = h + 2 * PAD, w + 2 * PAD
    return torch.stack([
        src_m @ dgp[:, R - ty:R - ty + hp, R - tx:R - tx + wp, :].reshape(-1, F)
        for ty, tx in _offsets()
    ])


# ------------------------------------------------------------------ wrappers


def _check(name: str, tensors: dict, dtype: torch.dtype, shapes: dict) -> None:
    """Device, dtype, shape and contiguity checks before a launch."""
    _cuda.require_cuda(*tensors.values())
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} takes f32 or bf16 sources, got {dtype}")
    for key, t in tensors.items():
        want = dtype if key in ("src", "w0s", "g_out") else torch.float32
        if t.dtype != want:
            raise TypeError(f"{name}: {key} must be {want}, got {t.dtype}")
        if tuple(t.shape) != shapes[key]:
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, expected {shapes[key]}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    # what the kernels tile (attn_fused.cu, bad_dims): channel pairs (the
    # wrappers run an odd count through with_even_channels), and the batch
    # on the 5x5 products' grid z axis
    b, c = shapes["src"][0], shapes["src"][3]
    if c < 2 or c % 2:
        raise ValueError(f"{name} needs an even channel count, got {c}")
    if b > 65535:
        raise ValueError(f"{name} takes at most 65535 images per launch, got {b}")


# per wrapper: {argument position: its channel axis}, and (output position
# or None for a lone tensor, its channel axis)
_CHANNEL_AXES = {"attn_fused_fwd": ({0: 3, 2: 1}, (0, 3)),
                 "attn_fused_bwd_c": ({0: 3, 6: 3}, (0, 3)),
                 "attn_fused_bwd_a_gsrc": ({5: 1}, (0, 3)),
                 "attn_fused_bwd_a_dw": ({0: 3}, (None, 1))}


def with_even_channels(name: str, fn, *args):
    """fn, the B4 wrapper `name` or its plain version, on arguments of an
    odd channel count C, run at C + 1: one zero channel appended to the
    source, the source-half weights and g_out, and the per-channel output
    (out, the source gradient, dW) cut back to C. A zero channel adds an
    exact zero to every channel sum, so the other outputs are those of C
    channels up to the order of the sums; the kernels tile channel pairs."""
    ins, (pos, axis) = _CHANNEL_AXES[name]
    args = [F_.pad(a, [0, 0] * (a.dim() - 1 - ins[i]) + [0, 1]).contiguous() if i in ins else a
            for i, a in enumerate(args)]
    res = fn(*args)
    cut = lambda t: t.narrow(axis, 0, t.shape[axis] - 1).contiguous()
    if pos is None:
        return cut(res)
    return tuple(cut(t) if i == pos else t for i, t in enumerate(res))


def _shapes(b, h, w, c) -> dict:
    pix = (b, h, w)
    return dict(src=(b, h, w, c), acc0=(b, h, w, F), w0s=(K2, c, F), w1=(F, K2), b1=(1, K2),
                fy=pix, fx=pix, wy=pix, wx=pix, attn=(b, h, w, K2), g_out=(b, h, w, c),
                g_acc=(b, h, w, F), dg=(b, h + 2 * HALO, w + 2 * HALO, F))


def _launch(symbol: str, count_as: str, argtypes, args) -> None:
    fn = _cuda.kernel("attn_fused", symbol, argtypes)
    _cuda.check("attn_fused", fn(*args, _cuda.stream_ptr()), count_as)
    _cuda.count_launch(count_as)


def _ptrs(*tensors):
    return [t.data_ptr() for t in tensors]


def kernel_tiling() -> dict:
    """The tile constants as the built attn_fused library reports them
    (`hoig_attn_fused_tiling`), under TILING's keys. Needs the card's build."""
    fn = _cuda.kernel("attn_fused", "hoig_attn_fused_tiling",
                      [ctypes.POINTER(ctypes.c_int), ctypes.c_int])
    buf = (ctypes.c_int * len(TILING))()
    n = fn(buf, len(TILING))
    if n != len(TILING):
        raise RuntimeError(f"attn_fused reports {n} tile constants, TILING has {len(TILING)}")
    return dict(zip(TILING, buf))


def _tc_splits(b: int, oh: int, ow: int, n: int) -> int:
    """Split-K factor of a tensor-core 5x5 product over an (oh, ow) frame
    with n outputs: contiguous ranges of the 25 offsets, enough that about
    two blocks run on each SM (at most 25); a second pass adds the partials
    in order (no float atomics). It counts conv5_tc_kernel's tiling
    (TILING); if the copy parts from the kernel's, only the speed suffers."""
    edge, n_t = TILING["tc_tile"], TILING["tc_n"]
    tiles = b * -(-oh // edge) * -(-ow // edge)
    blocks = -(-tiles // TILING["tc_tiles_per_block"]) * -(-n // n_t)
    return max(1, min(K2, -(-2 * _SMS // blocks)))


def _dw_tc_splits(b: int, h: int, w: int, c: int) -> int:
    """Split-K factor of the tensor-core dW: contiguous ranges of the pixels
    of the (H+6) x (W+6) frame. dw_tc_kernel runs one block per SM, so the
    factor is the smallest whose 25 x ceil(C/128) x splits blocks fill at
    least 90% of their last wave on the card, or else the one that fills it
    best; each range keeps at least 16 chunks of 64 pixels (at most 32
    ranges). A second pass adds the partials in order (no float atomics).
    It counts dw_tc_kernel's tiling (TILING)."""
    tiles = K2 * -(-c // TILING["dw_tc_channels"])
    chunks = -(-(b * (h + 2 * HALO) * (w + 2 * HALO)) // TILING["dw_tc_pixels"])
    choices = range(1, max(1, min(32, chunks // 16)) + 1)

    def fill(s):
        return tiles * s / (_SMS * -(-tiles * s // _SMS))

    return next((s for s in choices if fill(s) >= 0.9), max(choices, key=fill))


def attn_fused_fwd(src, acc0, w0s, w1, b1, fy_rel, fx_rel, wy, wx):
    """B4-fwd: (out (B, H, W, C) in src's dtype, acc (B, H, W, 128) f32,
    attn (B, H, W, 25) f32). A bf16 source runs phase A's product on the
    tensor cores, an f32 one as FP32."""
    if src.device.type == "cpu":
        return attn_fused_fwd_reference(src, acc0, w0s, w1, b1, fy_rel, fx_rel, wy, wx)
    b, h, w, c = src.shape
    if c % 2:
        return with_even_channels("attn_fused_fwd", attn_fused_fwd, src, acc0, w0s, w1, b1,
                                  fy_rel, fx_rel, wy, wx)
    _check("attn_fused_fwd", dict(src=src, acc0=acc0, w0s=w0s, w1=w1, b1=b1, fy=fy_rel,
                                  fx=fx_rel, wy=wy, wx=wx), src.dtype, _shapes(b, h, w, c))
    f32 = dict(dtype=torch.float32, device=src.device)
    out = torch.empty_like(src)
    acc = torch.empty((b, h, w, F), **f32)
    attn = torch.empty((b, h, w, K2), **f32)
    hg, wg = h + 2 * HALO, w + 2 * HALO
    g = torch.empty((b, hg, wg, F), **f32)
    ptrs = _ptrs(src, acc0, w0s, w1, b1, fy_rel, fx_rel, wy, wx, out, acc, attn, g)
    if src.dtype == torch.bfloat16:
        splits = _tc_splits(b, hg, wg, F)
        part = torch.empty((splits, b, hg, wg, F), **f32) if splits > 1 else g
        _launch("hoig_attn_fused_fwd_tc", "attn_fused_fwd_tc", _FWD_TC_ARGS,
                ptrs + [part.data_ptr(), b, h, w, c, splits])
    else:
        _launch("hoig_attn_fused_fwd", "attn_fused_fwd", _FWD_ARGS, ptrs + [b, h, w, c, 0])
    return out, acc, attn


def attn_fused_bwd_c(src, fy_rel, fx_rel, wy, wx, attn, g_out):
    """B4-bwd-c: (gsrc_c (B, H, W, C) f32, g_attn (B, H, W, 25) f32); g_out
    is taken in src's dtype."""
    if src.device.type == "cpu":
        return attn_fused_bwd_c_reference(src, fy_rel, fx_rel, wy, wx, attn, g_out)
    b, h, w, c = src.shape
    if c % 2:
        return with_even_channels("attn_fused_bwd_c", attn_fused_bwd_c, src, fy_rel, fx_rel, wy,
                                  wx, attn, g_out)
    _check("attn_fused_bwd_c", dict(src=src, fy=fy_rel, fx=fx_rel, wy=wy, wx=wx, attn=attn,
                                    g_out=g_out), src.dtype, _shapes(b, h, w, c))
    f32 = dict(dtype=torch.float32, device=src.device)
    gsrc = torch.empty((b, h, w, c), **f32)
    g_attn = torch.empty((b, h, w, K2), **f32)
    # each channel group's partial g_attn dots, added in order by the second launch
    groups = -(-c // TILING["bwd_c_channels"])
    dots = torch.empty((groups, b * h * w, BOX), **f32)
    _launch("hoig_attn_fused_bwd_c", "attn_fused_bwd_c", _BWD_C_ARGS,
            _ptrs(src, fy_rel, fx_rel, wy, wx, attn, g_out, gsrc, g_attn, dots)
            + [b, h, w, c, groups, int(src.dtype == torch.bfloat16)])
    return gsrc, g_attn


def attn_fused_bwd_a_gsrc(g_acc, fy_rel, fx_rel, wy, wx, w0s):
    """B4-bwd-a-gsrc: (the fc_0 half of the source gradient (B, H, W, C)
    f32, dG (B, H+6, W+6, 128) f32 for attn_fused_bwd_a_dw). bf16 weights
    run the projection on the tensor cores (dG split in three), f32 ones as
    FP32."""
    if g_acc.device.type == "cpu":
        return attn_fused_bwd_a_gsrc_reference(g_acc, fy_rel, fx_rel, wy, wx, w0s)
    b, h, w, _ = g_acc.shape
    c = w0s.shape[1]
    if c % 2:
        return with_even_channels("attn_fused_bwd_a_gsrc", attn_fused_bwd_a_gsrc, g_acc, fy_rel,
                                  fx_rel, wy, wx, w0s)
    _check("attn_fused_bwd_a_gsrc", dict(g_acc=g_acc, fy=fy_rel, fx=fx_rel, wy=wy, wx=wx,
                                         w0s=w0s), w0s.dtype, _shapes(b, h, w, c))
    f32 = dict(dtype=torch.float32, device=g_acc.device)
    gsrc = torch.empty((b, h, w, c), **f32)
    dg = torch.empty((b, h + 2 * HALO, w + 2 * HALO, F), **f32)
    hp, wp = h + 2 * PAD, w + 2 * PAD
    gpad = torch.empty((b, hp, wp, c), **f32)
    ptrs = _ptrs(g_acc, fy_rel, fx_rel, wy, wx, w0s, gsrc, dg, gpad)
    if w0s.dtype == torch.bfloat16:
        splits = _tc_splits(b, hp, wp, c)
        part = torch.empty((splits, b, hp, wp, c), **f32) if splits > 1 else gpad
        _launch("hoig_attn_fused_bwd_a_gsrc_tc", "attn_fused_bwd_a_gsrc_tc", _BWD_A_GSRC_TC_ARGS,
                ptrs + [part.data_ptr(), b, h, w, c, splits])
    else:
        _launch("hoig_attn_fused_bwd_a_gsrc", "attn_fused_bwd_a_gsrc", _BWD_A_GSRC_ARGS,
                ptrs + [b, h, w, c, 0])
    return gsrc, dg


def _dw_slices(c: int) -> int:
    """Slices of the pixel sum of the FP32 dW: each of the 25 * ceil(C/64)
    output tiles (TILING's dw_channels) is split so that about two blocks
    run on each SM; a second pass adds the slices in order (no float
    atomics)."""
    tiles = K2 * (-(-c // TILING["dw_channels"]))
    return max(1, min(32, -(-2 * _SMS // tiles)))


def attn_fused_bwd_a_dw(src, dg):
    """B4-bwd-a-dw: dW (25, C, 128) f32 from the source and the dG that
    attn_fused_bwd_a_gsrc returned. A bf16 source runs the product on the
    tensor cores (dG split in three), an f32 one as FP32."""
    if src.device.type == "cpu":
        return attn_fused_bwd_a_dw_reference(src, dg)
    b, h, w, c = src.shape
    if c % 2:
        return with_even_channels("attn_fused_bwd_a_dw", attn_fused_bwd_a_dw, src, dg)
    _check("attn_fused_bwd_a_dw", dict(src=src, dg=dg), src.dtype, _shapes(b, h, w, c))
    f32 = dict(dtype=torch.float32, device=src.device)
    dw = torch.empty((K2, c, F), **f32)
    if src.dtype == torch.bfloat16:
        splits = _dw_tc_splits(b, h, w, c)
        part = torch.empty((splits, K2, c, F), **f32) if splits > 1 else dw
        _launch("hoig_attn_fused_bwd_a_dw_tc", "attn_fused_bwd_a_dw_tc", _BWD_A_DW_TC_ARGS,
                _ptrs(src, dg, dw, part) + [b, h, w, c, splits])
    else:
        slices = _dw_slices(c)
        part = torch.empty((slices, K2, c, F), **f32)
        _launch("hoig_attn_fused_bwd_a_dw", "attn_fused_bwd_a_dw", _BWD_A_DW_ARGS,
                _ptrs(src, dg, dw, part) + [b, h, w, c, slices, 0])
    return dw


# ------------------------------------------------------------- public op


class FlowAttentionFused(torch.autograd.Function):
    """The fused attention with its hand-written backward (the JAX package's
    custom VJP `flow_attention_fused`). The flow fields get no gradient."""

    @staticmethod
    def forward(ctx, src, acc0, w0s, w1, b1, fy_rel, fx_rel, wy, wx):
        out, acc, attn = attn_fused_fwd(src, acc0, w0s, w1, b1, fy_rel, fx_rel, wy, wx)
        ctx.save_for_backward(src, w0s, w1, fy_rel, fx_rel, wy, wx, acc, attn)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g_out):
        src, w0s, w1, fy_rel, fx_rel, wy, wx, acc, attn = ctx.saved_tensors
        fields = (fy_rel, fx_rel, wy, wx)
        gsrc_c, g_attn = attn_fused_bwd_c(src, *fields, attn, g_out.to(src.dtype).contiguous())
        # phase B backward (plain tensor code): softmax -> fc_1 -> leaky_relu
        g_logits = attn * (g_attn - (attn * g_attn).sum(-1, keepdim=True))
        g_hdn = g_logits @ w1.float().t()
        hdn = torch.where(acc >= 0, acc, 0.01 * acc)
        g_w1 = torch.einsum("bhwf,bhwk->fk", hdn, g_logits)
        g_b1 = g_logits.sum(dim=(0, 1, 2))[None]
        g_acc = torch.where(acc >= 0, g_hdn, 0.01 * g_hdn).contiguous()
        gsrc_a, dg = attn_fused_bwd_a_gsrc(g_acc, *fields, w0s)
        dw = attn_fused_bwd_a_dw(src, dg)
        return ((gsrc_c + gsrc_a).to(src.dtype), g_acc, dw.to(w0s.dtype), g_w1.to(w1.dtype),
                g_b1.float(), None, None, None, None)


def flow_attention_fused(src, acc0, w0s, w1, b1, fy_rel, fx_rel, wy, wx) -> torch.Tensor:
    """Fused flow-guided local attention (k = 5), the JAX argument order.

    src (B, H, W, C) f32 or bf16; acc0 (B, H, W, 128) f32, the fc_0 target
    half plus bias; w0s (25, C, 128) in src's dtype, offsets row-major
    (ty, tx); w1 (128, 25) and b1 (1, 25) f32; fy_rel, fx_rel, wy, wx
    (B, H, W) f32 from `flow_fields`. Returns (B, H, W, C) in src's dtype."""
    return FlowAttentionFused.apply(src, acc0, w0s, w1, b1, fy_rel, fx_rel, wy, wx)
