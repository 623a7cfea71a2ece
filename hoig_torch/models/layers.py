"""Building blocks of the HOGAN generator (port of hoig_tpu/models/layers.py).

Activations are NCHW tensors, kept in `channels_last` memory so that the
NHWC views the attention takes are free. Each block runs in an explicit
`compute_dtype` (float32 or bfloat16), as the JAX package's process-wide
compute dtype does: parameters stay f32 and are cast per call, InstanceNorm
statistics are taken in f32. Module and parameter names follow the
reference's torch modules, so `state_dict()` keys are the reference's.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


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


class InstanceNorm(nn.Module):
    """InstanceNorm2d (eps 1e-5) with f32 statistics folded into one
    per-(sample, channel) scale and offset, applied in the compute dtype."""

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
        var, mean = torch.var_mean(x.float(), dim=(2, 3), correction=0, keepdim=True)
        a = torch.rsqrt(var + self.eps)
        b = -mean * a
        if self.weight is not None:
            scale = self.weight[None, :, None, None]
            a = a * scale
            b = b * scale + self.bias[None, :, None, None]
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
