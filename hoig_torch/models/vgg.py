"""VGG19 feature pyramid and perceptual loss (port of hoig_tpu/models/vgg.py).

Five feature slices, cut after the ReLU of conv ordinals 1, 3, 5, 9 and 13
(or before it, with `before_relu`), and an L1 feature distance weighted
1/32, 1/16, 1/8, 1/4, 1. The convs sit in `features` at torchvision's
indices (`features.{0,2,5,...,28}`), so a torchvision vgg19 state dict
fits by key. Without such a file the weights are seeded random numbers and
the loss is a random-feature perceptual loss. Parameters are frozen.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from hoig_torch.models.layers import Conv2d, init_weights
from hoig_torch.ops._cuda import resolve_device

# conv widths per stage of VGG19 'features', up to the 13th convolution
_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512, 512, "M", 512)
_SLICE_AFTER = (1, 3, 5, 9, 13)
VGG_LOSS_WEIGHTS = (1.0 / 32, 1.0 / 16, 1.0 / 8, 1.0 / 4, 1.0)


class Vgg19Features(nn.Module):
    """VGG19 convs up to the 13th; returns the 5-slice pyramid, NHWC."""

    def __init__(self, before_relu: bool = False, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.before_relu = before_relu
        layers, cin = [], 3
        for item in _CFG:
            if item == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [Conv2d(cin, item, 3, 1, 1, compute_dtype=compute_dtype), nn.ReLU()]
                cin = item
        self.features = nn.Sequential(*layers)
        self.requires_grad_(False)

    def forward(self, x: torch.Tensor):
        x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        outs, conv_i = [], 0
        for layer in self.features:
            if isinstance(layer, nn.ReLU):
                pre, x = x, layer(x)
                if conv_i in _SLICE_AFTER:
                    outs.append((pre if self.before_relu else x).permute(0, 2, 3, 1))
                continue
            x = layer(x)
            conv_i += isinstance(layer, nn.Conv2d)
        return outs


def init_vgg(seed: int = 0, before_relu: bool = False,
             compute_dtype: torch.dtype = torch.float32, device="cuda") -> Vgg19Features:
    """A frozen Vgg19Features with weights drawn from `seed`, on `device`
    (CUDA unless the caller names the CPU)."""
    dev = resolve_device(device)
    model = Vgg19Features(before_relu, compute_dtype)
    init_weights(model, seed)
    return model.to(device=dev, memory_format=torch.channels_last).eval()


def vgg_perceptual_loss(model: Vgg19Features, x: torch.Tensor, y: torch.Tensor,
                        valid=None) -> torch.Tensor:
    """Weighted L1 over the 5 slices. x, y: (B, H, W, 3) NHWC in [-1, 1] (no
    ImageNet normalization, as the reference feeds tanh outputs straight in);
    y is a constant target. valid: optional per-sample weights (B,)."""
    from hoig_torch.train.losses import wmean  # train/ imports models/

    fx = model(x)
    with torch.no_grad():
        fy = model(y)
    loss = 0.0
    for w, a, b in zip(VGG_LOSS_WEIGHTS, fx, fy):
        # features may be bf16 under the compute dtype; means are taken in f32
        d = (a - b).abs()
        loss = loss + w * (wmean(d, valid) if valid is not None else d.float().mean())
    return loss
