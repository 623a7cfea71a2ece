"""FID InceptionV3 in PyTorch (port of hoig_tpu/metrics/inception.py;
reference metrics/pytorch_fid/inception.py).

The FID-specific InceptionV3 (the 1008-class TF export: average-pool
branches with count_include_pad=False in InceptionA / C / E_1 and a max-pool
branch in the second InceptionE) up to the pool3 2048-d features. The
modules carry pytorch-fid's names (`Mixed_5b.branch1x1.conv.weight`, ...),
so its `pt_inception-2015-12-05` state dict loads by key
(`load_torch_weights`); without it the weights are seeded random numbers,
useful for timing and plumbing only, not for comparable FID values.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class BasicConv2d(nn.Module):
    """conv (no bias) -> BatchNorm (eps 0.001, running statistics) -> ReLU."""

    def __init__(self, cin: int, cout: int, kernel, stride: int = 1, pad=(0, 0)):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=pad, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=0.001)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _avgpool3_cip_false(x):
    """3x3 stride-1 pad-1 average pool that counts only the pixels inside."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=False)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, pad=(2, 2))
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, pad=(1, 1))
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, pad=(1, 1))
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avgpool3_cip_false(x))
        return torch.cat([self.branch1x1(x), b5, b3, bp], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, pad=(1, 1))
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, F.max_pool2d(x, 3, 2)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), pad=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), pad=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), pad=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), pad=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), pad=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), pad=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        bp = self.branch_pool(_avgpool3_cip_false(x))
        return torch.cat([self.branch1x1(x), b7, bd, bp], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), pad=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), pad=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, F.max_pool2d(x, 3, 2)], 1)


class InceptionE(nn.Module):
    def __init__(self, cin: int, pool_mode: str = "avg_fid"):
        super().__init__()
        self.pool_mode = pool_mode  # 'avg_fid' (Mixed_7b) or 'max' (Mixed_7c)
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), pad=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), pad=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, pad=(1, 1))
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), pad=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), pad=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        bp = F.max_pool2d(x, 3, 1, 1) if self.pool_mode == "max" else _avgpool3_cip_false(x)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(bp)], 1)


class FIDInceptionV3(nn.Module):
    """Pool3 (2048-d) feature extractor; NCHW input in [0, 1].

    As the reference's InceptionV3(resize_input=True, normalize_input=True)
    (inception.py:118-147) and the JAX package's, whose resize is
    jax.image.resize(..., "bilinear"): half-pixel centres, antialiased when
    shrinking. Then scale to [-1, 1], blocks 0..3, global average pool."""

    def __init__(self, resize_input: bool = True, normalize_input: bool = True):
        super().__init__()
        self.resize_input = resize_input
        self.normalize_input = normalize_input
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, pad=(1, 1))
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg_fid")
        self.Mixed_7c = InceptionE(2048, "max")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.resize_input:
            x = resize_bilinear(x, (299, 299))
        if self.normalize_input:
            x = 2.0 * x - 1.0
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = F.max_pool2d(x, 3, 2)
        x = F.max_pool2d(self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x)), 3, 2)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c",
                     "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))  # (B, 2048) global average pool


def resize_bilinear(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """jax.image.resize(..., "bilinear") on NCHW: half-pixel centres, a
    tent filter widened by the scale (antialias) along an axis that shrinks,
    weights renormalized at the edges. One axis at a time: torch's
    antialiased kernel is the plain bilinear one when enlarging, but less
    exact (about 4e-6 on [0, 1] images against 1e-7), so it is used only
    where it changes the weights. A same-size resize returns x."""
    for axis, n in ((2, size[0]), (3, size[1])):
        if x.shape[axis] != n:
            out = list(x.shape[2:])
            out[axis - 2] = n
            x = F.interpolate(x, size=tuple(out), mode="bilinear", align_corners=False,
                              antialias=n < x.shape[axis])
    return x


def init_inception(seed: int = 0) -> FIDInceptionV3:
    """FIDInceptionV3 with seeded random weights (He-normal convolutions,
    unit BatchNorm), drawn from a CPU generator: for timing and plumbing."""
    model = FIDInceptionV3()
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen) * (2.0 / fan_in) ** 0.5)
    return model.eval()


def load_torch_weights(model: FIDInceptionV3, state_dict: dict) -> FIDInceptionV3:
    """Load a pytorch-fid pt_inception state dict by key. Its 1008-class `fc`
    (unused by FID) is skipped, and a missing `num_batches_tracked` keeps the
    model's; any other missing or unknown key raises."""
    own = model.state_dict()
    state = {k: v for k, v in state_dict.items() if not k.startswith("fc.")}
    unknown = sorted(set(state) - set(own))
    missing = sorted(k for k in set(own) - set(state) if not k.endswith("num_batches_tracked"))
    if unknown or missing:
        raise KeyError(f"not a FID Inception state dict: {len(missing)} keys missing "
                       f"{missing[:3]}, {len(unknown)} unknown {unknown[:3]}")
    model.load_state_dict({**own, **{k: torch.as_tensor(v) for k, v in state.items()}})
    return model
