"""Dataset substrate: numpy samples (port of hoig_tpu/data/dataset_base.py).

The crop pipeline shared by the dataset variants: the patch-affine crop
(its matrix from `get_affine_transform`, its warp through the native
runtime), the [-1, 1] normalization and the image-extension walk, and
`rodrigues` for the object rotations. The JAX package calls cv2 for the
two matrices; these compute them as OpenCV does, in float64, and give its
bits. Samples are plain numpy dicts collated by the loader; the model
facade moves them to the device.
"""

from __future__ import annotations

import math
import os
import pickle

import numpy as np

IMG_EXTENSIONS = (".jpg", ".JPG", ".jpeg", ".JPEG", ".png", ".PNG", ".ppm", ".PPM", ".bmp",
                  ".BMP")


def rotate_2d(pt_2d, rot_rad):
    x, y = pt_2d[0], pt_2d[1]
    sn, cs = np.sin(rot_rad), np.cos(rot_rad)
    return np.array([x * cs - y * sn, x * sn + y * cs], dtype=np.float32)


def _lu_solve(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """OpenCV's LU solve (hal::LU64f: Gaussian elimination with partial
    pivoting, then back substitution), in its order of operations."""
    a, b = a.copy(), b.copy()
    m = a.shape[0]
    for i in range(m):
        k = i + int(np.argmax(np.abs(a[i:, i])))  # the first row of the largest |pivot|
        if abs(a[k, i]) < np.finfo(np.float64).eps * 10:
            raise ValueError("the affine points are collinear")
        if k != i:
            a[[i, k], i:] = a[[k, i], i:]
            b[[i, k]] = b[[k, i]]
        d = -1.0 / a[i, i]
        for j in range(i + 1, m):
            alpha = a[j, i] * d
            a[j, i + 1:] += alpha * a[i, i + 1:]
            b[j] += alpha * b[i]
    for i in range(m - 1, -1, -1):
        s = b[i]
        for k in range(i + 1, m):
            s -= a[i, k] * b[k]
        b[i] = s / a[i, i]
    return b


def get_affine_transform(src, dst) -> np.ndarray:
    """cv2.getAffineTransform: the (2, 3) float64 affine map of three points
    onto three others, bit for bit (the points taken as float32, the 6 x 6
    system solved in float64 as OpenCV solves it)."""
    src = np.asarray(src, np.float32).astype(np.float64).reshape(3, 2)
    dst = np.asarray(dst, np.float32).astype(np.float64).reshape(3, 2)
    a = np.zeros((6, 6))
    for i in range(3):
        a[2 * i, :2] = a[2 * i + 1, 3:5] = src[i]
        a[2 * i, 2] = a[2 * i + 1, 5] = 1.0
    return _lu_solve(a, dst.reshape(6)).reshape(2, 3)


def rodrigues(rvec) -> np.ndarray:
    """cv2.Rodrigues(rvec)[0]: the (3, 3) rotation of an axis-angle vector of
    3 elements, computed in float64 as OpenCV does and returned in the
    vector's float dtype."""
    r = np.asarray(rvec)
    if r.size != 3 or r.dtype not in (np.float32, np.float64):
        raise ValueError(f"expected a float32 or float64 vector of 3 elements, got {r.dtype} "
                         f"{r.shape}")
    x, y, z = (float(v) for v in r.reshape(3))
    theta = math.sqrt(x * x + y * y + z * z)
    if theta < np.finfo(np.float64).eps:
        return np.eye(3, dtype=r.dtype)
    c, s = math.cos(theta), math.sin(theta)
    itheta = 1.0 / theta
    x, y, z = x * itheta, y * itheta, z * itheta
    rrt = np.array([[x * x, x * y, x * z], [x * y, y * y, y * z], [x * z, y * z, z * z]])
    r_x = np.array([[0.0, -z, y], [z, 0.0, -x], [-y, x, 0.0]])
    return (c * np.eye(3) + (1.0 - c) * rrt + s * r_x).astype(r.dtype)


def gen_trans_from_patch_cv(c_x, c_y, src_width, src_height, dst_width, dst_height, scale, rot,
                            inv=False):
    """The (2, 3) affine map of a rotated, scaled box onto the patch (or back)."""
    src_w = src_width * scale
    src_h = src_height * scale
    src_center = np.array([c_x, c_y], dtype=np.float32)
    rot_rad = np.pi * rot / 180
    src_downdir = rotate_2d(np.array([0, src_h * 0.5], np.float32), rot_rad)
    src_rightdir = rotate_2d(np.array([src_w * 0.5, 0], np.float32), rot_rad)

    dst_center = np.array([dst_width * 0.5, dst_height * 0.5], np.float32)
    dst_downdir = np.array([0, dst_height * 0.5], np.float32)
    dst_rightdir = np.array([dst_width * 0.5, 0], np.float32)

    src = np.stack([src_center, src_center + src_downdir, src_center + src_rightdir])
    dst = np.stack([dst_center, dst_center + dst_downdir, dst_center + dst_rightdir])
    if inv:
        trans = get_affine_transform(np.float32(dst), np.float32(src))
    else:
        trans = get_affine_transform(np.float32(src), np.float32(dst))
    return trans.astype(np.float32)


def generate_patch_image(cvimg, bbox, do_flip, scale, rot, out_shape):
    """bbox crop -> (out_shape) patch, its affine and the inverse affine."""
    from hoig_torch.runtime import warp_affine

    img = cvimg
    img_height, img_width = img.shape[:2]
    bb_c_x = float(bbox[0] + 0.5 * bbox[2])
    bb_c_y = float(bbox[1] + 0.5 * bbox[3])
    bb_width = float(bbox[2])
    bb_height = float(bbox[3])
    if do_flip:
        img = img[:, ::-1, :]
        bb_c_x = img_width - bb_c_x - 1
    trans = gen_trans_from_patch_cv(bb_c_x, bb_c_y, bb_width, bb_height, out_shape[1],
                                    out_shape[0], scale, rot)
    patch = warp_affine(np.ascontiguousarray(img), trans, (int(out_shape[0]), int(out_shape[1])))
    inv_trans = gen_trans_from_patch_cv(bb_c_x, bb_c_y, bb_width, bb_height, out_shape[1],
                                        out_shape[0], scale, rot, inv=True)
    return patch, trans, inv_trans


def augmentation(img, bbox, out_size=256):
    """The crop used at train and eval alike (no augmentation)."""
    patch, trans, _ = generate_patch_image(img.copy(), bbox, False, 1.0, 0.0,
                                           (out_size, out_size))
    return patch, trans


def normalize_image(img_float01_hwc: np.ndarray) -> np.ndarray:
    """HWC [0, 1] -> CHW [-1, 1]."""
    return (img_float01_hwc.transpose(2, 0, 1) * 2.0 - 1.0).astype(np.float32)


def load_pickle_data(path):
    if not os.path.exists(path):
        raise FileNotFoundError(f"Unable to find annotations pickle file at {path}")
    with open(path, "rb") as fp:
        try:
            return pickle.load(fp, encoding="latin1")
        except Exception:
            fp.seek(0)
            return pickle.load(fp)


class DatasetBase:
    """Map-style numpy dataset."""

    def __init__(self, opt, is_for_train: bool):
        self._name = "BaseDataset"
        self._opt = opt
        self._is_for_train = is_for_train

    @property
    def name(self):
        return self._name

    def _is_image_file(self, filename: str) -> bool:
        return filename.endswith(IMG_EXTENSIONS)

    def _get_all_files_in_subfolders(self, dir, is_file):
        if not os.path.isdir(dir):
            raise NotADirectoryError(f"{dir} is not a valid directory")
        out = []
        for root, _, fnames in sorted(os.walk(dir)):
            out.extend(os.path.join(root, f) for f in fnames if is_file(f))
        return out

    def __len__(self):
        raise NotImplementedError

    def __getitem__(self, item):
        raise NotImplementedError
