"""Loss functions of the HOGAN GAN objective (port of hoig_tpu/train/losses.py):
LSGAN quadratic adversarial loss with targets {0, 1, -1}, L1 reconstruction,
BCE / MSE mask losses and the total-variation mask smoothness term. The VGG
perceptual loss lives in hoig_torch.models.vgg.
"""

from __future__ import annotations

import torch


def wmean(x: torch.Tensor, w: torch.Tensor | None) -> torch.Tensor:
    """mean(x), or, with per-sample weights w (B,), the w-weighted mean of
    the per-sample f32 means. Every sample has the same element count, so
    w = ones reproduces mean(x); the eval path gives pad-replica samples
    weight 0."""
    if w is None:
        return x.mean()
    per = x.reshape(x.shape[0], -1).float().mean(dim=1)
    return (per * w).sum() / w.sum().clamp_min(1.0)


def lsgan_loss(logits: torch.Tensor, target: float, w=None) -> torch.Tensor:
    """mean((x - y)^2); targets: 0 for the generator's D(fake), 1 for
    D(real), -1 for the discriminator's D(fake)."""
    return wmean((logits - target) ** 2, w)


def l1_loss(x: torch.Tensor, y: torch.Tensor, w=None) -> torch.Tensor:
    return wmean((x - y).abs(), w)


def mse_loss(x: torch.Tensor, y: torch.Tensor, w=None) -> torch.Tensor:
    return wmean((x - y) ** 2, w)


def _clamped_log(x: torch.Tensor) -> torch.Tensor:
    """max(log(max(x, 0)), -100) with a zero gradient where x <= 0. (Written
    as log followed by a clamp, the backward multiplies the clamp's zero by
    the log's 1/0 and yields NaN; a bf16 sigmoid does reach exactly 0 and 1.)"""
    tiny = torch.finfo(torch.float32).tiny
    floor = torch.full_like(x, -100.0)
    return torch.where(x > 0, torch.log(x.clamp_min(tiny)), floor).clamp_min(-100.0)


def bce_loss(pred: torch.Tensor, target: torch.Tensor, w=None) -> torch.Tensor:
    """torch.nn.BCELoss semantics: mean binary cross entropy on
    probabilities, with the logs clamped at -100; a saturated prediction
    (exactly 0 or 1) gets no gradient from its clamped log."""
    return -wmean(target * _clamped_log(pred) + (1.0 - target) * _clamped_log(1.0 - pred), w)


def tv_smooth_loss(mat: torch.Tensor, w=None) -> torch.Tensor:
    """Mask smoothness: mean |dx| + mean |dy| over the two spatial axes of a
    (B, C, H, W) or (B, H, W, C) mask. The layout is read off the shape:
    NCHW when dim 1 is no larger than the last dim, else NHWC."""
    if mat.ndim != 4:
        raise ValueError(f"expected 4D mask, got {tuple(mat.shape)}")
    ax_h, ax_w = (2, 3) if mat.shape[1] <= mat.shape[-1] else (1, 2)
    n_w, n_h = mat.shape[ax_w], mat.shape[ax_h]
    dx = (mat.narrow(ax_w, 0, n_w - 1) - mat.narrow(ax_w, 1, n_w - 1)).abs()
    dy = (mat.narrow(ax_h, 0, n_h - 1) - mat.narrow(ax_h, 1, n_h - 1)).abs()
    return wmean(dx, w) + wmean(dy, w)
