"""Binary-mask morphology as thresholded box sums (reference util.morph):
erode pads with 1s and needs a full ks x ks window of 1s; dilate pads with
0s and fires on any 1 in the window."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def morph(mask: torch.Tensor, ks: int, mode: str = "erode") -> torch.Tensor:
    """Erode or dilate a {0,1} float mask (..., H, W) with a ks x ks box."""
    if ks % 2 != 1:
        raise ValueError(f"morph kernel size must be odd, got {ks}")
    if mode not in ("erode", "dilate"):
        raise ValueError(f"unknown morph mode: {mode}")
    pad = ks // 2
    shape = mask.shape
    x = mask.reshape(-1, 1, shape[-2], shape[-1])
    x = F.pad(x, (pad, pad, pad, pad), value=1.0 if mode == "erode" else 0.0)
    summed = F.avg_pool2d(x, ks, stride=1, divisor_override=1)
    thresh = ks * ks - 0.5 if mode == "erode" else 0.5
    return (summed >= thresh).to(mask.dtype).reshape(shape)
