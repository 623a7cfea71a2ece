"""InterHand2.6M eval-pair dataset (port of hoig_tpu/data/eval_dataset.py;
reference data/eval_dataset.py:83-156).

Vestigial in the reference too — it is never registered in the dataset
factory (data/__init__.py registers only 'hov3'); kept for capability
parity: pair-list-driven sampling of InterHand captures with two-hand MANO
params and full camera (campos/camrot/focal/princpt) per sample.
"""

from __future__ import annotations

import json
import os

import numpy as np

from hoig_torch.data.dataset_base import (
    DatasetBase,
    augmentation,
    load_pickle_data,
    normalize_image,
)
from hoig_torch.runtime import imread


class InterHandEvalDataset(DatasetBase):
    def __init__(self, opt, is_for_train: bool = True):
        super().__init__(opt, is_for_train)
        self._name = "InterHandDataset"
        self.param_dir = os.path.join(opt.data_dir, opt.params_dir)
        self.pic_dir = os.path.join(opt.data_dir, opt.images_dir)
        self.image_size = getattr(opt, "image_size", 256)

        if not os.path.exists(self.param_dir):
            raise ValueError(f"param_dir: {self.param_dir} not exist")
        if not os.path.exists(self.pic_dir):
            raise ValueError(f"pic_dir: {self.pic_dir} not exist")

        with open(os.path.join(
                self.param_dir, "InterHand2.6M_train_MANO_NeuralAnnot.json")) as f:
            self.mano_params = json.load(f)
        with open(os.path.join(
                self.param_dir, "InterHand2.6M_train_camera.json")) as f:
            self.cam_params = json.load(f)
        self.bbx_params = load_pickle_data(
            os.path.join(self.param_dir, "InterHand_Tiny_bbx.pkl")
        )
        eval_dict = load_pickle_data(opt.eval_pairs)
        self._eval_list = [[s, t] for s in eval_dict for t in eval_dict[s]]
        self._num_videos = len(self._eval_list)

    def __len__(self):
        return self._num_videos * self._opt.num_repeats

    def __getitem__(self, index):
        src, tsf = self._eval_list[index % self._num_videos]
        capture_id, cam_id, action_id = src.split("/")[:3]
        image_a, mano_a = self._get_sample(
            capture_id, cam_id, action_id, src.split("/")[-1]
        )
        image_b, mano_b = self._get_sample(
            capture_id, cam_id, action_id, tsf.split("/")[-1]
        )
        return {"imageA": image_a, "manoA": mano_a,
                "imageB": image_b, "manoB": mano_b,
                "pathA": src, "pathB": tsf}

    def _get_sample(self, capture_id, cam_id, action_id, frame_id):
        image = imread(
            os.path.join(self.pic_dir, capture_id, cam_id, action_id, frame_id)
        )
        bbox = self.bbx_params[os.path.join(capture_id, cam_id, action_id)]
        image, trans = augmentation(image, bbox, self.image_size)
        image_chw = normalize_image((image / 255.0)[:, :, ::-1])

        cams = self.cam_params[capture_id[7:]]
        theta = {}
        for hand_type in ("left", "right"):
            mp = self.mano_params[capture_id[7:]][frame_id[5:-4]][hand_type]
            hand_np = np.asarray(
                mp["pose"] + mp["shape"] + mp["trans"], np.float32
            )
            cam_np = np.asarray(
                cams["campos"][cam_id[3:]]
                + cams["camrot"][cam_id[3:]][0]
                + cams["camrot"][cam_id[3:]][1]
                + cams["camrot"][cam_id[3:]][2]
                + cams["focal"][cam_id[3:]]
                + cams["princpt"][cam_id[3:]],
                np.float32,
            )
            theta[hand_type] = np.concatenate(
                [cam_np, trans.reshape(-1), hand_np], axis=0
            )
        return image_chw, theta
