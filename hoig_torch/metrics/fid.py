"""FID score (port of hoig_tpu/metrics/fid.py; reference
metrics/pytorch_fid/fid_score.py).

Pool3 activations of the FID InceptionV3 -> mean / covariance -> Fréchet
distance with scipy.linalg.sqrtm, with the singular-product eps fallback and
the imaginary-component check (fid_score.py:147-200). PNGs are decoded by
the port's stdlib decoder; a file it cannot decode raises. The network runs
on the card unless the caller passes device="cpu", in f32 with TF32 off.

    python -m hoig_torch.metrics.fid dirA dirB [--weights pt_inception.pth] [--device cpu]
"""

from __future__ import annotations

import inspect
import os
import warnings

import numpy as np
import torch
from scipy import linalg

from hoig_torch.metrics.inception import init_inception, load_torch_weights
from hoig_torch.metrics.precision import f32_exact
from hoig_torch.ops._cuda import resolve_device
from hoig_torch.utils.util import read_png


def make_inception(weights_path: str | None = None, device="cuda"):
    """model_fn(x) -> (B, 2048) pool3 activations on the host, for x an
    (B, 3, H, W) float32 array in [0, 1]."""
    from hoig_torch.train.checkpoints import load_state_dict_file

    dev = resolve_device(device)
    model = init_inception(seed=0)
    if weights_path:
        load_torch_weights(model, load_state_dict_file(weights_path))
        print(f"loaded FID inception weights from {weights_path}")
    else:
        print("[warn] FID inception running with random init — values are NOT comparable "
              "FID scores (supply --weights)")
    model = model.to(dev).eval()

    @torch.no_grad()
    def model_fn(x: np.ndarray) -> np.ndarray:
        with f32_exact():
            return model(torch.from_numpy(x).to(dev)).cpu().numpy()

    return model_fn


def get_activations(files, model_fn, batch_size: int = 50) -> np.ndarray:
    """Images (paths) -> (N, 2048) pool3 activations, from raw [0, 1] pixels
    as pytorch-fid's ToTensor pipeline (fid_score.py:115); the network
    resizes and normalizes."""
    if batch_size > len(files):
        print("Warning: batch size is bigger than the data size. Setting batch size to data size")
        batch_size = len(files)
    preds = []
    for i in range(0, len(files), batch_size):
        imgs = np.stack([read_png(f).astype(np.float32) / 255.0
                         for f in files[i:i + batch_size]]).transpose(0, 3, 1, 2)
        # the tail is padded to a full batch, as the JAX package's fixed jit shape does
        n = imgs.shape[0]
        if n < batch_size:
            imgs = np.concatenate([imgs, np.zeros((batch_size - n,) + imgs.shape[1:], np.float32)])
        preds.append(model_fn(np.ascontiguousarray(imgs))[:n])
    return np.concatenate(preds, axis=0)


def _sqrtm(a: np.ndarray) -> np.ndarray:
    """scipy's matrix square root, without its printed error estimate:
    pytorch-fid passes disp=False, a keyword that SciPy 1.18 removed (its
    sqrtm then returns the root alone and prints nothing)."""
    if "disp" in inspect.signature(linalg.sqrtm).parameters:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            return linalg.sqrtm(a, disp=False)[0]
    return linalg.sqrtm(a)


def calculate_frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """Numpy Fréchet distance, the exact pytorch-fid formulation."""
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    if mu1.shape != mu2.shape or sigma1.shape != sigma2.shape:
        raise ValueError("the two distributions have statistics of different shapes")
    diff = mu1 - mu2
    covmean = _sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        print(f"fid calculation produces singular product; adding {eps} to diagonal of cov "
              "estimates")
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            raise ValueError("Imaginary component {}".format(np.max(np.abs(covmean.imag))))
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


def calculate_activation_statistics(files, model_fn, batch_size: int = 50):
    act = get_activations(files, model_fn, batch_size)
    return np.mean(act, axis=0), np.cov(act, rowvar=False)


def compute_statistics_of_path(path, model_fn, batch_size: int = 50):
    if path.endswith(".npz"):
        with np.load(path) as f:
            return f["mu"][:], f["sigma"][:]
    files = sorted(os.path.join(path, f) for f in os.listdir(path)
                   if f.lower().endswith((".png", ".jpg", ".jpeg", ".bmp")))
    return calculate_activation_statistics(files, model_fn, batch_size)


def calculate_fid_given_paths(paths, batch_size: int = 50, weights_path: str | None = None,
                              device="cuda") -> float:
    for p in paths:
        if not os.path.exists(p):
            raise RuntimeError(f"Invalid path: {p}")
    model_fn = make_inception(weights_path, device)
    m1, s1 = compute_statistics_of_path(paths[0], model_fn, batch_size)
    m2, s2 = compute_statistics_of_path(paths[1], model_fn, batch_size)
    return calculate_frechet_distance(m1, s1, m2, s2)


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="FID of two image folders")
    p.add_argument("path", nargs=2)
    p.add_argument("--batch-size", type=int, default=50)
    p.add_argument("--weights", type=str, default=None,
                   help="pt_inception-2015-12-05 state dict (.pth / .npz)")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    fid = calculate_fid_given_paths(args.path, args.batch_size, args.weights, args.device)
    print("FID: ", fid)
    return fid


if __name__ == "__main__":
    main()
