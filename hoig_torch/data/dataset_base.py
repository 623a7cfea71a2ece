"""Dataset substrate: numpy samples (port of hoig_tpu/data/dataset_base.py).

The crop pipeline shared by the dataset variants: the patch-affine crop
(its matrix from cv2.getAffineTransform, its warp through the native
runtime), the [-1, 1] normalization and the image-extension walk. Samples
are plain numpy dicts collated by the loader; the model facade moves them
to the device. cv2 is imported only where a real-data sample needs it.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

IMG_EXTENSIONS = (".jpg", ".JPG", ".jpeg", ".JPEG", ".png", ".PNG", ".ppm", ".PPM", ".bmp",
                  ".BMP")


def rotate_2d(pt_2d, rot_rad):
    x, y = pt_2d[0], pt_2d[1]
    sn, cs = np.sin(rot_rad), np.cos(rot_rad)
    return np.array([x * cs - y * sn, x * sn + y * cs], dtype=np.float32)


def gen_trans_from_patch_cv(c_x, c_y, src_width, src_height, dst_width, dst_height, scale, rot,
                            inv=False):
    """The (2, 3) affine map of a rotated, scaled box onto the patch (or back)."""
    import cv2

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
        trans = cv2.getAffineTransform(np.float32(dst), np.float32(src))
    else:
        trans = cv2.getAffineTransform(np.float32(src), np.float32(dst))
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
