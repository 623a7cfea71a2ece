"""LPIPS (port of hoig_tpu/metrics/lpips.py; reference metrics/lpips.py):
AlexNet ReLU features, unit-normalized over channels, squared differences
through learned 1x1 weights, averaged and summed over the five layers.

The modules keep the reference's keys: `alexnet.features.{0,3,6,8,10}` are
torchvision's alexnet.features indices (its state dict loads by key) and
`lpips_weights.{i}.main.1.weight` those of lpips_weights.ckpt. Without them
the weights are seeded random numbers (timing and plumbing only). The
path API keeps the reference's quirk: it feeds 299x299 ImageNet-normalized
images (get_eval_loader's defaults), to which LPIPS applies its own
[-1, 1]-range shift and scale. Runs on the card unless the caller passes
device="cpu", in f32 with TF32 off.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn as nn

from hoig_torch.metrics.precision import f32_exact
from hoig_torch.ops._cuda import resolve_device

# (out_ch, kernel, stride, pad) of torchvision alexnet.features' convs
_ALEX_CFG = ((64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1), (256, 3, 1, 1), (256, 3, 1, 1))
# their indices in alexnet.features
_ALEX_TORCH_IDX = (0, 3, 6, 8, 10)

LPIPS_MU = np.array([-0.03, -0.088, -0.188], np.float32)
LPIPS_SIGMA = np.array([0.458, 0.448, 0.450], np.float32)


class AlexNetFeatures(nn.Module):
    """torchvision's alexnet.features; returns the 5 post-ReLU maps."""

    def __init__(self):
        super().__init__()
        layers, cin = [], 3
        for i, (c, k, s, p) in enumerate(_ALEX_CFG):
            layers += [nn.Conv2d(cin, c, k, s, p), nn.ReLU()]
            if i in (0, 1, 4):
                layers.append(nn.MaxPool2d(3, 2))
            cin = c
        self.features = nn.Sequential(*layers)

    def forward(self, x):
        fmaps = []
        for layer in self.features:
            x = layer(x)
            if isinstance(layer, nn.ReLU):
                fmaps.append(x)
        return fmaps


class _Conv1x1(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.main = nn.Sequential(nn.Dropout(0.5), nn.Conv2d(cin, 1, 1, bias=False))

    def forward(self, x):
        return self.main(x)


class LPIPSNet(nn.Module):
    """AlexNet features + learned 1x1 weights -> a scalar distance of two
    NCHW batches (the mean over the batch)."""

    def __init__(self):
        super().__init__()
        self.alexnet = AlexNetFeatures()
        self.lpips_weights = nn.ModuleList(_Conv1x1(c) for c, *_ in _ALEX_CFG)
        self.register_buffer("mu", torch.from_numpy(LPIPS_MU).view(1, 3, 1, 1), persistent=False)
        self.register_buffer("sigma", torch.from_numpy(LPIPS_SIGMA).view(1, 3, 1, 1),
                             persistent=False)

    def forward(self, x, y):
        fx = self.alexnet((x - self.mu) / self.sigma)
        fy = self.alexnet((y - self.mu) / self.sigma)

        def unit(v):
            return v * torch.rsqrt((v ** 2).sum(dim=1, keepdim=True) + 1e-10)

        val = 0.0
        for lin, a, b in zip(self.lpips_weights, fx, fy):
            val = val + lin((unit(a) - unit(b)) ** 2).mean()
        return val


def init_lpips(seed: int = 0) -> LPIPSNet:
    """LPIPSNet with seeded random weights (He-normal AlexNet, zero biases,
    non-negative 1x1 weights), drawn from a CPU generator."""
    model = LPIPSNet()
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                w = torch.randn(m.weight.shape, generator=gen) * (2.0 / fan_in) ** 0.5
                m.weight.copy_(w.abs() if m.out_channels == 1 else w)
                if m.bias is not None:
                    m.bias.zero_()
    return model.eval()


def load_weights(model: LPIPSNet, alexnet_path: str | None, lpips_path: str | None) -> LPIPSNet:
    """torchvision's alexnet state dict (its features.{0,3,6,8,10} convs; the
    classifier is not used) and the reference's lpips_weights.ckpt
    (lpips_weights.{i}.main.1.weight), each a .pth or .npz; a missing key
    raises."""
    from hoig_torch.train.checkpoints import load_state_dict_file

    own = model.state_dict()
    if alexnet_path:
        state = load_state_dict_file(alexnet_path)
        for ti in _ALEX_TORCH_IDX:
            for leaf in ("weight", "bias"):
                own[f"alexnet.features.{ti}.{leaf}"] = torch.as_tensor(
                    state[f"features.{ti}.{leaf}"])
    if lpips_path:
        state = load_state_dict_file(lpips_path)
        for i in range(len(_ALEX_CFG)):
            key = f"lpips_weights.{i}.main.1.weight"
            own[key] = torch.as_tensor(state[key])
    model.load_state_dict(own)
    return model


def make_lpips(alexnet_weights: str | None = None, lpips_weights: str | None = None,
               device="cuda"):
    """lpips_fn(x, y) -> host float, for x and y (B, 3, H, W) float32 arrays
    or tensors."""
    dev = resolve_device(device)
    model = init_lpips(seed=0)
    if alexnet_weights or lpips_weights:
        load_weights(model, alexnet_weights, lpips_weights)
    else:
        print("[warn] LPIPS running with random init — values are NOT comparable (supply "
              "alexnet + lpips weights)")
    model = model.to(dev).eval()

    @torch.no_grad()
    def lpips_fn(x, y) -> float:
        with f32_exact():
            return float(model(torch.as_tensor(x).to(dev), torch.as_tensor(y).to(dev)))

    return lpips_fn


def calculate_lpips_given_images(gen_images, gt_images, lpips_fn=None, device="cuda"):
    """(N, 3, H, W) [-1, 1] NCHW pairs -> per-frame LPIPS values."""
    lpips_fn = lpips_fn or make_lpips(device=device)
    return np.asarray([lpips_fn(gen_images[i:i + 1], gt_images[i:i + 1])
                       for i in range(gen_images.shape[0])])


def calculate_lpips_given_paths(paths, img_size: int = 256, batch_size: int = 50,
                                alexnet_weights=None, lpips_weights=None, device="cuda") -> float:
    """The mean over batches of each batch's LPIPS (the reference's loop)."""
    from hoig_torch.metrics.image_loader import iter_eval_images

    print(f"Calculating LPIPS given paths {paths[0]} and {paths[1]}...")
    lpips_fn = make_lpips(alexnet_weights, lpips_weights, device)
    vals = [lpips_fn(a, b) for a, b in zip(
        iter_eval_images(paths[0], img_size, batch_size, imagenet_normalize=True),
        iter_eval_images(paths[1], img_size, batch_size, imagenet_normalize=True))]
    return float(np.mean(vals))


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="LPIPS of two PNG folders")
    p.add_argument("path", nargs="*", default=[os.path.join("results", "imitators"),
                                               os.path.join("results", "gt")])
    p.add_argument("--img_size", type=int, default=256)
    p.add_argument("--alexnet", default=None)
    p.add_argument("--lpips_weights", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    print(calculate_lpips_given_paths(args.path, args.img_size, alexnet_weights=args.alexnet,
                                      lpips_weights=args.lpips_weights, device=args.device))


if __name__ == "__main__":
    main()
