"""HO3Dv3 dataset (port of hoig_tpu/data/hov3_dataset.py; reference
data/hov3_dataset.py).

Per-video frame-pair sampling at train, pickle pair list at eval; bbox crop
to 256x256; HO3D meta pickles -> MANO pose/shape/trans + camMat + rigid
object pose; object verts transformed and zero-padded; masks from
mask/<frame>.png divided by 128 (hov3_dataset.py:226-236).
"""

from __future__ import annotations

import os

import numpy as np

from hoig_torch.data.dataset_base import (
    DatasetBase,
    augmentation,
    load_pickle_data,
    normalize_image,
)
from hoig_torch.geometry.mesh import load_obj

OBJNAMES = [
    "003_cracker_box", "004_sugar_box", "006_mustard_bottle",
    "010_potted_meat_can", "011_banana", "021_bleach_cleanser",
    "025_mug", "035_power_drill", "037_scissors",
]

# object verts zero-padded to this count (hov3_dataset.py:246)
OBJ_VERTS_PAD = 7866


def read_annotation(base_dir, seq_name, file_id, split):
    path = os.path.join(base_dir, split, seq_name, "meta", file_id + ".pkl")
    return load_pickle_data(path)


class HOv3Dataset(DatasetBase):
    def __init__(self, opt, is_for_train: bool = True):
        super().__init__(opt, is_for_train)
        self._name = "HOv3Dataset"
        self.data_dir = opt.data_dir
        self.param_dir = os.path.join(opt.data_dir, opt.params_dir)
        self.pic_dir = os.path.join(opt.data_dir, opt.images_dir)
        self.data_split = "train" if is_for_train else "test"
        self.pairs_dir = opt.pairs_dir
        self.obj_dir = getattr(opt, "obj_dir", "assets/obj")
        self.image_size = getattr(opt, "image_size", 256)

        if not os.path.exists(self.param_dir):
            raise ValueError(f"param_dir: {self.param_dir} not exist")
        if not os.path.exists(self.pic_dir):
            raise ValueError(f"pic_dir: {self.pic_dir} not exist")

        self.bbx_params = load_pickle_data(
            os.path.join(self.param_dir, "HOv3-CR_bbx.pkl")
        )
        vids_file = "HOv3-CR_train_new.pkl" if is_for_train else "HOv3-CR_test_new.pkl"
        self._vids_dict = load_pickle_data(os.path.join(self.param_dir, vids_file))

        self._pairs_list = (
            load_pickle_data(self.pairs_dir) if os.path.exists(self.pairs_dir) else None
        )
        self._vids_list = list(self._vids_dict)
        self._num_videos = (
            len(self._vids_list) if self._pairs_list is None else len(self._pairs_list)
        )
        self._obj_cache = {}
        self._rng = np.random.RandomState()

    def set_seed(self, seed: int):
        self._rng = np.random.RandomState(seed)

    def __len__(self):
        return self._num_videos * self._opt.num_repeats

    def __getitem__(self, index):
        if self._pairs_list is None:
            vid_id = self._vids_list[index % self._num_videos]
            frames = self._vids_dict[vid_id]
            vid_a = vid_b = vid_id
            frame_a, frame_b = self._rng.choice(frames, size=2, replace=False)
        else:
            path_a, path_b = self._pairs_list[index % self._num_videos]
            vid_a, frame_a = path_a.split("/")
            vid_b, frame_b = path_b.split("/")

        image_a, mask_a, mano_a = self._get_sample(vid_a, frame_a)
        image_b, mask_b, mano_b = self._get_sample(vid_b, frame_b)
        return {
            "imageA": image_a, "maskA": mask_a, "manoA": mano_a,
            "nameA": os.path.join(vid_a, str(frame_a)),
            "imageB": image_b, "maskB": mask_b, "manoB": mano_b,
            "nameB": os.path.join(vid_b, str(frame_b)),
        }

    def _load_obj_verts(self, obj_name: str) -> np.ndarray:
        if obj_name not in self._obj_cache:
            path = os.path.join(self.obj_dir, obj_name, obj_name + ".obj")
            self._obj_cache[obj_name] = load_obj(path)["vertices"]
        return self._obj_cache[obj_name]

    def _get_sample(self, vid_id, frame_id):
        import cv2

        frame_id = str(frame_id)
        seq = vid_id.split("_")[0]
        rgb_rel = os.path.join(seq, "rgb", frame_id)
        split = (
            "train"
            if os.path.exists(os.path.join(self.pic_dir, "train", rgb_rel))
            else "test"
        )
        image = cv2.imread(os.path.join(self.pic_dir, split, rgb_rel))
        mask = cv2.imread(
            os.path.join(
                self.pic_dir, split, seq, "mask",
                "%05d.png" % int(frame_id.split(".")[0]),
            )
        )
        mask = cv2.resize(mask, (640, 480))

        bbox = self.bbx_params[vid_id]
        image, trans = augmentation(image, bbox, self.image_size)
        mask, _ = augmentation(mask, bbox, self.image_size)

        image_chw = normalize_image((image / 255.0)[:, :, ::-1])
        mask_1hw = (mask / 128.0)[None, :, :, -1].astype(np.float32)

        anno = read_annotation(self.pic_dir, seq, frame_id.split(".")[0], split)
        obj_name = anno["objName"]
        obj_v = self._load_obj_verts(obj_name)
        rot = cv2.Rodrigues(anno["objRot"])[0]
        vertices_obj = np.zeros((OBJ_VERTS_PAD, 3), np.float32)
        v_now = obj_v @ rot.T + anno["objTrans"]
        vertices_obj[: v_now.shape[0]] = v_now

        theta = {
            "cam": anno["camMat"].astype(np.float32),
            "trans": trans.astype(np.float32),
            "pose": anno["handPose"].astype(np.float32),
            "shape": anno["handBeta"].astype(np.float32),
            "handtrans": anno["handTrans"].astype(np.float32),
            "vertices_obj": vertices_obj,
            "obj_id": np.int32(OBJNAMES.index(obj_name)),
        }
        return image_chw, mask_1hw, theta
