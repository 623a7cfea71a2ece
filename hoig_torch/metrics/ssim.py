"""SSIM / MS-SSIM in PyTorch (port of hoig_tpu/metrics/ssim.py; reference
metrics/ssim.py + pytorch_msssim).

The standard Wang et al. SSIM with an 11-tap Gaussian window (sigma 1.5,
K1 = 0.01, K2 = 0.03), valid-mode windowing as a separable filter (two
grouped conv2d), and the 5-scale MS-SSIM with weights [0.0448, 0.2856,
0.3001, 0.2363, 0.1333], relu-clamped cs and 2x2 average-pool downsampling
that zero-pads an odd edge. Entry points run on the card unless the caller
passes device="cpu"; f32 with TF32 off.

    python -m hoig_torch.metrics.ssim <dir_a> <dir_b> [img_size] [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from hoig_torch.metrics.precision import f32_exact
from hoig_torch.ops._cuda import resolve_device

MS_SSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    coords = np.arange(size, dtype=np.float64) - size // 2
    g = np.exp(-(coords ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _blur(x: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """Separable valid-mode Gaussian filter on (B, C, H, W)."""
    b, c, h, w = x.shape
    k = win.shape[0]
    x = x.reshape(b * c, 1, h, w)
    x = F.conv2d(F.conv2d(x, win.view(1, 1, k, 1)), win.view(1, 1, 1, k))
    return x.reshape(b, c, h - k + 1, w - k + 1)


def _ssim_per_channel(x, y, win, data_range, k1=0.01, k2=0.03):
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    mu_x, mu_y = _blur(x, win), _blur(y, win)
    sigma_x = _blur(x * x, win) - mu_x ** 2
    sigma_y = _blur(y * y, win) - mu_y ** 2
    sigma_xy = _blur(x * y, win) - mu_x * mu_y
    cs_map = (2 * sigma_xy + c2) / (sigma_x + sigma_y + c2)
    ssim_map = ((2 * mu_x * mu_y + c1) / (mu_x ** 2 + mu_y ** 2 + c1)) * cs_map
    # per-sample means over C, H, W
    return ssim_map.mean(dim=(1, 2, 3)), cs_map.mean(dim=(1, 2, 3))


def _window(x: torch.Tensor, size: int, sigma: float) -> torch.Tensor:
    return torch.from_numpy(_gaussian_window(size, sigma)).to(x.device)


def ssim(x: torch.Tensor, y: torch.Tensor, data_range: float = 255.0, size_average: bool = True,
         win_size: int = 11, win_sigma: float = 1.5) -> torch.Tensor:
    """SSIM on (B, C, H, W); pytorch_msssim.ssim's defaults."""
    with f32_exact():
        val, _ = _ssim_per_channel(x.float(), y.float(), _window(x, win_size, win_sigma),
                                   data_range)
    return val.mean() if size_average else val


def _avg_pool2(x: torch.Tensor) -> torch.Tensor:
    h, w = x.shape[-2:]
    if h % 2 or w % 2:
        x = F.pad(x, (0, w % 2, 0, h % 2))
    return F.avg_pool2d(x, 2, 2)


def ms_ssim(x: torch.Tensor, y: torch.Tensor, data_range: float = 255.0,
            size_average: bool = True, win_size: int = 11, win_sigma: float = 1.5,
            weights=MS_SSIM_WEIGHTS) -> torch.Tensor:
    """Multi-scale SSIM; relu-clamped cs like pytorch_msssim."""
    win = _window(x, win_size, win_sigma)
    x, y = x.float(), y.float()
    mcs = []
    with f32_exact():
        for i in range(len(weights)):
            val, cs = _ssim_per_channel(x, y, win, data_range)
            if i < len(weights) - 1:
                mcs.append(F.relu(cs))
                x, y = _avg_pool2(x), _avg_pool2(y)
    out = F.relu(val) ** weights[-1]
    for w, cs in zip(weights, mcs):
        out = out * cs ** w
    return out.mean() if size_average else out


def crop_image(img0, img1, pts):
    """Keypoint-bbox crop (reference metrics/ssim.py:11-34)."""
    u, v = pts[:, 0], pts[:, 1]
    b = round(1.5 * max(u.max() - u.min(), v.max() - v.min()))
    us = int(max((u.min() + u.max() - b) / 2, 0))
    ue = int(min((u.min() + u.max() + b) / 2, 255))
    vs = int(max((v.min() + v.max() - b) / 2, 0))
    ve = int(min((v.min() + v.max() + b) / 2, 255))
    return img0[:, :, vs:ve + 1, us:ue + 1], img1[:, :, vs:ve + 1, us:ue + 1]


def calculate_ssim_given_paths(paths, img_size: int = 256, batch_size: int = 1,
                               device="cuda") -> tuple[float, float]:
    """Path-pair SSIM + MS-SSIM (reference metrics/ssim.py:37-59).

    The reference's quirk is kept on purpose: get_eval_loader's default
    imagenet_normalize=True (299x299, ImageNet mean / std) while ssim runs
    with data_range=255 (ssim.py:40,50-52)."""
    from hoig_torch.metrics.image_loader import iter_eval_images

    dev = resolve_device(device)
    print(f"Calculating SSIM given paths {paths[0]} and {paths[1]}...")
    ssim_vals, msssim_vals = [], []
    for img0, img1 in zip(iter_eval_images(paths[0], img_size, batch_size, imagenet_normalize=True),
                          iter_eval_images(paths[1], img_size, batch_size, imagenet_normalize=True)):
        a, b = torch.from_numpy(img0).to(dev), torch.from_numpy(img1).to(dev)
        ssim_vals.append(ssim(a, b, data_range=255, size_average=False).cpu().numpy())
        msssim_vals.append(ms_ssim(a, b, data_range=255, size_average=False).cpu().numpy())
    return float(np.concatenate(ssim_vals).mean()), float(np.concatenate(msssim_vals).mean())


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="SSIM and MS-SSIM of two PNG folders")
    p.add_argument("path", nargs=2)
    p.add_argument("img_size", nargs="?", type=int, default=256)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    s, ms = calculate_ssim_given_paths(args.path, img_size=args.img_size, device=args.device)
    print(f"SSIM: {s}  MS-SSIM: {ms}")


if __name__ == "__main__":
    main()
