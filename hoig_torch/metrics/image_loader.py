"""Folder -> array eval loader (port of hoig_tpu/metrics/image_loader.py;
reference data/default_dataset.py).

The JAX package decodes with PIL and resizes twice with PIL's BILINEAR
(to img_size, then to 299). The port does not import PIL (a machine that
runs it need not have it), so the PNGs are decoded by the port's decoder
(hoig_torch.utils.util.decode_png)
and resized by `pil_bilinear_resize`, bit-equal to PIL: its double-
precision tent weights turned into 22-bit fixed point, a horizontal pass,
clipped and rounded to uint8, then a vertical pass; a same-size resize is a
copy. (torch's interpolate is not bit-equal to it.) All on the host, in
numpy.
"""

from __future__ import annotations

import functools
import os

import numpy as np

from hoig_torch.utils.util import read_png

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
_PRECISION_BITS = 32 - 8 - 2  # Pillow's Resample.c


@functools.lru_cache(maxsize=16)
def _bilinear_weights(in_size: int, out_size: int) -> np.ndarray:
    """Pillow's precompute_coeffs + normalize_coeffs_8bpc for its BILINEAR
    filter (support 1), as an (in_size, out_size) matrix of the 22-bit
    fixed-point weights (integers held in float64, so that a product with
    uint8 samples and the sums of a window are exact). Cached per size pair
    (read-only)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filterscale
    dense = np.zeros((in_size, out_size), np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        ss = 1.0 / filterscale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        weights = [max(0.0, 1.0 - abs((x + xmin - center + 0.5) * ss)) for x in range(xmax)]
        total = 0.0
        for w in weights:
            total += w
        for x, w in enumerate(weights):
            w = w / total if total != 0.0 else w
            dense[xmin + x, xx] = int((-0.5 if w < 0 else 0.5) + w * (1 << _PRECISION_BITS))
    dense.setflags(write=False)
    return dense


def _resample_axis(img: np.ndarray, axis: int, out_size: int) -> np.ndarray:
    in_size = img.shape[axis]
    if in_size == out_size:
        return img
    moved = np.ascontiguousarray(np.moveaxis(img, axis, -1), dtype=np.float64)
    # integer products and sums below 2^53: the float64 product is exact
    acc = (moved.reshape(-1, in_size) @ _bilinear_weights(in_size, out_size)).astype(np.int64)
    out = np.clip((acc + (1 << (_PRECISION_BITS - 1))) >> _PRECISION_BITS, 0, 255)
    return np.moveaxis(out.astype(np.uint8).reshape(moved.shape[:-1] + (out_size,)), -1, axis)


def pil_bilinear_resize(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """(H, W, C) uint8 -> (size[1], size[0], C) uint8, bit-equal to PIL's
    `Image.resize(size, Image.BILINEAR)` (size is (width, height), as in
    PIL): the horizontal pass, then the vertical one."""
    return _resample_axis(_resample_axis(img, 1, size[0]), 0, size[1])


def list_images(root: str) -> list:
    return sorted(os.path.join(root, f) for f in os.listdir(root))


def load_eval_image(path: str, img_size: int = 256, imagenet_normalize: bool = True,
                    as_uint8_range: bool = False) -> np.ndarray:
    """-> (3, H, W) float32, normalized like get_eval_loader
    (default_dataset.py:28-45)."""
    img = pil_bilinear_resize(read_png(path), (img_size, img_size))
    if imagenet_normalize:
        img = pil_bilinear_resize(img, (299, 299))
        arr = np.asarray(img, np.float32) / 255.0
        arr = (arr - IMAGENET_MEAN) / IMAGENET_STD
    elif as_uint8_range:
        arr = np.asarray(img, np.float32)  # [0, 255] for SSIM data_range=255
    else:
        arr = (np.asarray(img, np.float32) / 255.0 - 0.5) / 0.5
    return arr.transpose(2, 0, 1)


def iter_eval_images(root: str, img_size: int = 256, batch_size: int = 32,
                     imagenet_normalize: bool = True, as_uint8_range: bool = False):
    files = list_images(root)
    for i in range(0, len(files), batch_size):
        yield np.stack([load_eval_image(f, img_size, imagenet_normalize, as_uint8_range)
                        for f in files[i:i + batch_size]])
