"""Building blocks of the HOGAN generator (port of hoig_tpu/models/layers.py).

Activations are NCHW tensors, kept in `channels_last` memory so that the
NHWC views the attention takes are free. Each block runs in an explicit
`compute_dtype` (float32 or bfloat16), as the JAX package's process-wide
compute dtype does: parameters stay f32 and are cast per call, InstanceNorm
statistics are taken in f32. Module and parameter names follow the
reference's torch modules, so `state_dict()` keys are the reference's.

InstanceNorm statistics under remat (the JAX package's checkpoint policy
`save_only_these_names("in_stats")`): a region that the generator
rematerializes runs inside `keep_stats`, whose stash records each
InstanceNorm's folded f32 scale and offset on the region's first call and
hands them back, in call order, to the recompute in the backward pass. The
recompute then runs no statistics reduction; the gradient still flows
through the statistics (`FoldedStats`'s hand-written backward, which the
original forward's autograd node runs). The stash belongs to the region's
checkpoint and dies with its autograd graph.
"""

from __future__ import annotations

import collections
import threading
import weakref

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.autograd.function import once_differentiable


class Conv2d(nn.Conv2d):
    """torch Conv2d run in the compute dtype (input, weight and bias cast)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1, pad: int = 0,
                 bias: bool = True, compute_dtype: torch.dtype = torch.float32):
        super().__init__(cin, cout, kernel, stride, pad, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(cd)
        return F.conv2d(x.to(cd), self.weight.to(cd), bias, self.stride, self.padding)


class ConvTranspose2d(nn.ConvTranspose2d):
    """2x upsampling transposed conv in torch's own geometry:
    ConvTranspose2d(k, stride 2, padding 1, output_padding k % 2), no bias."""

    def __init__(self, cin: int, cout: int, kernel: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(cin, cout, kernel, stride=2, padding=1, output_padding=kernel % 2,
                         bias=False)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        return F.conv_transpose2d(x.to(cd), self.weight.to(cd), None, self.stride, self.padding,
                                  self.output_padding)


# statistics reductions run ("computed") and pairs handed to a recompute
# ("kept"), since the last reset: the tests and chip_smoke.py read them
_STATS = collections.Counter()


def stats_counts() -> dict:
    return dict(_STATS)


def reset_stats_counts() -> None:
    _STATS.clear()


class FoldedStats(torch.autograd.Function):
    """InstanceNorm's folded f32 statistics of x (B, C, H, W): a = rstd *
    weight, b = bias - mean * a (weight and bias None: a = rstd, b = -mean *
    rstd), each (B, C, 1, 1), with rstd = (var + eps)^-1/2 over H, W.

    With `kept` (a pair that an earlier call computed on the same values)
    it returns that pair and reduces nothing. Either way it saves x and the
    weight for the backward, so that a checkpoint's recompute saves what
    the original forward saved; mean and rstd stay on the original call's
    node, out of the checkpoint's reach."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps: float, kept):
        if kept is None:
            var, mean = torch.var_mean(x.float(), dim=(2, 3), correction=0, keepdim=True)
            rstd = torch.rsqrt(var + eps)
            a, b = rstd, -mean * rstd
            if weight is not None:
                scale = weight[None, :, None, None]
                a = a * scale
                b = b * scale + bias[None, :, None, None]
            # detached: rstd itself is the output a when there is no weight
            ctx.mean, ctx.rstd = mean, rstd.detach()
            _STATS["computed"] += 1
        else:
            a, b = (t.detach() for t in kept)
            _STATS["kept"] += 1
        ctx.save_for_backward(x, weight)
        return a, b

    @staticmethod
    @once_differentiable
    def backward(ctx, ga, gb):
        x, weight = ctx.saved_tensors
        mean, rstd = ctx.mean, ctx.rstd
        # the gradient of rstd, through a0 = rstd and b0 = -mean * rstd
        g_rstd = ga - gb * mean
        g_weight = g_bias = None
        if weight is not None:
            g_weight = (g_rstd * rstd).sum(dim=(0, 2, 3))
            g_bias = gb.sum(dim=(0, 2, 3))
            scale = weight[None, :, None, None]
            g_rstd, gb = g_rstd * scale, gb * scale
        # then to x: d rstd / d var = -rstd^3 / 2, d var / dx = 2 (x - mean) / n
        # and d mean / dx = 1 / n, so gx = k1 x + k0
        n = x.shape[2] * x.shape[3]
        k1 = g_rstd * (rstd.pow(3) * (-1.0 / n))
        k0 = torch.addcmul(k1 * mean, gb, rstd, value=1.0 / n).neg()
        return torch.addcmul(k0, x, k1).to(x.dtype), g_weight, g_bias, None, None


class _Stash:
    """The folded statistics of one rematerialized region, in call order."""

    def __init__(self):
        self.pairs: list = []
        self.calls = 0
        self.cursor: int | None = None  # None while the first call records
        _LIVE.add(self)

    def begin(self) -> None:
        """A call of the region: the first records, every later one replays
        from the first pair (a recompute may stop early: none depends on
        where the last one stopped)."""
        self.cursor = None if self.calls == 0 else 0
        self.calls += 1

    def take(self, x: torch.Tensor):
        """The kept pair of the next InstanceNorm of a recompute, else None."""
        if self.cursor is None:
            return None
        if self.cursor >= len(self.pairs):
            raise RuntimeError("the recompute ran more InstanceNorms than the forward")
        a, b = self.pairs[self.cursor]
        if a.shape[:2] != x.shape[:2]:
            raise RuntimeError(f"kept statistics of shape {tuple(a.shape)} for an input of "
                               f"shape {tuple(x.shape)}")
        self.cursor += 1
        return a, b

    def put(self, a: torch.Tensor, b: torch.Tensor) -> None:
        if self.cursor is None:
            self.pairs.append((a.detach(), b.detach()))


_LIVE: "weakref.WeakSet[_Stash]" = weakref.WeakSet()


class _Active(threading.local):
    """The stash of the region that is running, per thread (the backward's
    recompute runs on autograd's device thread)."""

    stash: _Stash | None = None


_ACTIVE = _Active()


def live_stashes() -> int:
    """How many regions' stashes are alive: none once their graphs are gone."""
    return len(_LIVE)


def keep_stats(fn):
    """fn, run as a rematerialized region: its first call records the
    statistics of its InstanceNorms, every later call (the recompute) takes
    them back in the same order. Regions do not nest."""
    stash = _Stash()

    def region(*args):
        if _ACTIVE.stash is not None:
            raise RuntimeError("rematerialized regions do not nest")
        stash.begin()
        _ACTIVE.stash = stash
        try:
            return fn(*args)
        finally:
            _ACTIVE.stash = None

    return region


class InstanceNorm(nn.Module):
    """InstanceNorm2d (eps 1e-5) with f32 statistics folded into one
    per-(sample, channel) scale and offset (`FoldedStats`), applied in the
    compute dtype. Inside a `keep_stats` region the recompute takes the
    forward's statistics back instead of reducing x again."""

    def __init__(self, num_features: int, affine: bool = True, eps: float = 1e-5,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.compute_dtype = compute_dtype
        if affine:
            self.weight = nn.Parameter(torch.ones(num_features))
            self.bias = nn.Parameter(torch.zeros(num_features))
        else:
            self.weight = self.bias = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        stash = _ACTIVE.stash
        kept = None if stash is None else stash.take(x)
        a, b = FoldedStats.apply(x, self.weight, self.bias, self.eps, kept)
        if stash is not None:
            stash.put(a, b)
        return x.to(cd) * a.to(cd) + b.to(cd)


def conv_in_relu(cin: int, cout: int, kernel: int, stride: int, pad: int,
                 cd: torch.dtype) -> nn.Sequential:
    """Conv (no bias) -> InstanceNorm(affine) -> ReLU."""
    return nn.Sequential(Conv2d(cin, cout, kernel, stride, pad, bias=False, compute_dtype=cd),
                         InstanceNorm(cout, compute_dtype=cd), nn.ReLU())


def upconv_in_relu(cin: int, cout: int, kernel: int, cd: torch.dtype) -> nn.Sequential:
    """ConvTranspose 2x -> InstanceNorm(affine) -> ReLU."""
    return nn.Sequential(ConvTranspose2d(cin, cout, kernel, compute_dtype=cd),
                         InstanceNorm(cout, compute_dtype=cd), nn.ReLU())


class SPADE(nn.Module):
    """Spatially-adaptive norm: parameter-free InstanceNorm modulated by
    gamma / beta from the nearest-resized condition map (128-ch shared MLP)."""

    def __init__(self, norm_nc: int, label_nc: int, cd: torch.dtype):
        super().__init__()
        self.param_free_norm = InstanceNorm(norm_nc, affine=False, compute_dtype=cd)
        self.mlp_shared = nn.Sequential(Conv2d(label_nc, 128, 3, 1, 1, compute_dtype=cd), nn.ReLU())
        self.mlp_gamma = Conv2d(128, norm_nc, 3, 1, 1, compute_dtype=cd)
        self.mlp_beta = Conv2d(128, norm_nc, 3, 1, 1, compute_dtype=cd)

    def forward(self, x: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
        normalized = self.param_free_norm(x)
        h, w = x.shape[2], x.shape[3]
        if seg.shape[2] != h or seg.shape[3] != w:
            # F.interpolate(mode='nearest') floor mapping
            dev = seg.device
            rows = (torch.arange(h, device=dev) * (seg.shape[2] / h)).long()
            cols = (torch.arange(w, device=dev) * (seg.shape[3] / w)).long()
            seg = seg.index_select(2, rows).index_select(3, cols)
        actv = self.mlp_shared(seg)
        return normalized * (1.0 + self.mlp_gamma(actv)) + self.mlp_beta(actv)


class ResidualBlock(nn.Module):
    """conv-IN-ReLU-conv-IN plus a shortcut: the identity when dim_out is
    dim (every HOGAN config), else the learned InstanceNorm(affine) `norm_s`
    and 1x1 `conv_s` without bias."""

    def __init__(self, dim: int, cd: torch.dtype, dim_out: int | None = None):
        super().__init__()
        dim_out = dim if dim_out is None else dim_out
        self.main = nn.Sequential(
            Conv2d(dim, dim_out, 3, 1, 1, bias=False, compute_dtype=cd),
            InstanceNorm(dim_out, compute_dtype=cd), nn.ReLU(),
            Conv2d(dim_out, dim_out, 3, 1, 1, bias=False, compute_dtype=cd),
            InstanceNorm(dim_out, compute_dtype=cd),
        )
        self.learned_shortcut = dim_out != dim
        if self.learned_shortcut:
            self.norm_s = InstanceNorm(dim, compute_dtype=cd)
            self.conv_s = Conv2d(dim, dim_out, 1, bias=False, compute_dtype=cd)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.conv_s(self.norm_s(x)) if self.learned_shortcut else x
        return s + self.main(x)


class SPADEResidualBlock(nn.Module):
    """SPADE-ReLU-conv twice plus a shortcut: the identity when dim_out is
    dim, else the learned SPADE `norm_s` and 1x1 `conv_s` without bias."""

    def __init__(self, dim: int, label_nc: int, cd: torch.dtype, dim_out: int | None = None):
        super().__init__()
        dim_out = dim if dim_out is None else dim_out
        self.conv_0 = Conv2d(dim, dim_out, 3, 1, 1, compute_dtype=cd)
        self.conv_1 = Conv2d(dim_out, dim_out, 3, 1, 1, compute_dtype=cd)
        self.norm_0 = SPADE(dim, label_nc, cd)
        self.norm_1 = SPADE(dim_out, label_nc, cd)
        self.learned_shortcut = dim_out != dim
        if self.learned_shortcut:
            self.norm_s = SPADE(dim, label_nc, cd)
            self.conv_s = Conv2d(dim, dim_out, 1, bias=False, compute_dtype=cd)

    def forward(self, x: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
        s = self.conv_s(self.norm_s(x, seg)) if self.learned_shortcut else x
        y = self.conv_0(F.relu(self.norm_0(x, seg)))
        y = self.conv_1(F.relu(self.norm_1(y, seg)))
        return s + y


class SPADEBlock(nn.Module):
    """Strided (or transposed) conv -> SPADE -> ReLU."""

    def __init__(self, cin: int, cout: int, kernel: int, downsample: bool, label_nc: int,
                 cd: torch.dtype):
        super().__init__()
        if downsample:
            self.conv = Conv2d(cin, cout, kernel, 2, 1, bias=False, compute_dtype=cd)
        else:
            self.conv = ConvTranspose2d(cin, cout, kernel, compute_dtype=cd)
        self.norm = SPADE(cout, label_nc, cd)

    def forward(self, x: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
        return F.relu(self.norm(self.conv(x), seg))


@torch.no_grad()
def init_weights(module: nn.Module, seed: int) -> None:
    """normal(0, 0.02) conv weights, zero biases, unit norm scales (the
    reference's NetworkBase.init_weights), drawn from a seeded CPU generator."""
    gen = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            m.weight.copy_(torch.randn(m.weight.shape, generator=gen) * 0.02)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, InstanceNorm) and m.weight is not None:
            m.weight.fill_(1.0)
            m.bias.zero_()
