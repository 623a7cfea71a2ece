"""PatchGAN discriminators (port of hoig_tpu/models/discriminator.py).

  * PatchDiscriminator: pix2pix-style PatchGAN. n_layers stride-2 k=4 convs,
    then a stride-1 k=4 p=1 pair (each shrinks a spatial dim by 1);
    LeakyReLU(0.2); no sigmoid under LSGAN.
  * MultiScaleDiscriminator: n_scales independent PatchDiscriminators over a
    given input pyramid.

NHWC in and out, like the port's generator. The convs run in the compute
dtype; the layers sit in one `nn.Sequential` named `model`, so the
state-dict keys are the reference's (`model.{0,2,5,...}.weight`).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from hoig_torch.models.layers import Conv2d, InstanceNorm


class _BatchNorm(nn.BatchNorm2d):
    """BatchNorm2d with f32 statistics under a bf16 compute dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.float()).to(x.dtype)


class PatchDiscriminator(nn.Module):
    def __init__(self, input_nc: int, ndf: int = 64, n_layers: int = 3,
                 norm_type: str = "instance", use_sigmoid: bool = False,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        cd = compute_dtype
        if norm_type == "instance":
            norm = lambda ch: InstanceNorm(ch, affine=False, compute_dtype=cd)
        elif norm_type in ("batch", "batchnorm2d"):
            norm = _BatchNorm
        else:
            raise NotImplementedError(f"norm [{norm_type}] not found")
        bias = norm_type != "batch"
        layers = [Conv2d(input_nc, ndf, 4, 2, 1, compute_dtype=cd), nn.LeakyReLU(0.2)]
        nf = 1
        for n in range(1, n_layers):
            nf_prev, nf = nf, min(2 ** n, 8)
            layers += [Conv2d(ndf * nf_prev, ndf * nf, 4, 2, 1, bias=bias, compute_dtype=cd),
                       norm(ndf * nf), nn.LeakyReLU(0.2)]
        nf_prev, nf = nf, min(2 ** n_layers, 8)
        layers += [Conv2d(ndf * nf_prev, ndf * nf, 4, 1, 1, bias=bias, compute_dtype=cd),
                   norm(ndf * nf), nn.LeakyReLU(0.2),
                   Conv2d(ndf * nf, 1, 4, 1, 1, compute_dtype=cd)]
        if use_sigmoid:
            layers.append(nn.Sigmoid())
        self.model = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, input_nc) NHWC -> patch logits (B, h, w, 1)."""
        x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        return self.model(x).permute(0, 2, 3, 1)


class MultiScaleDiscriminator(nn.Module):
    def __init__(self, input_nc: int, n_scales: int = 5, ndf: int = 64, n_layers: int = 3,
                 use_sigmoid: bool = False, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        for i in range(n_scales):
            self.add_module(f"scale_{i}", PatchDiscriminator(
                input_nc, ndf, n_layers, use_sigmoid=use_sigmoid, compute_dtype=compute_dtype))
        self.n_scales = n_scales

    def forward(self, pyramid: Sequence[torch.Tensor]):
        return [getattr(self, f"scale_{i}")(pyramid[i]) for i in range(self.n_scales)]
