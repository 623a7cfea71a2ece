"""DexYCB dataset (port of hoig_tpu/data/ycb_dataset.py; reference
HOIG_DexYCB/data/ycb_dataset.py).

labels_{frame:06d}.npz (pose_y/pose_m) + valid_video_info.pkl intrinsics;
cam = [fx, fy, cx, cy]; object verts from the grasp pose matrix, padded to
8000; no masks in the sample dict (ycb_dataset.py:279-295).
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

# _YCB_CLASSES (HOIG_DexYCB/utils/nmr.py:14-36): id -> name, 1-based
YCB_CLASSES = {
    1: "002_master_chef_can", 2: "003_cracker_box", 3: "004_sugar_box",
    4: "005_tomato_soup_can", 5: "006_mustard_bottle", 6: "007_tuna_fish_can",
    7: "008_pudding_box", 8: "009_gelatin_box", 9: "010_potted_meat_can",
    10: "011_banana", 11: "019_pitcher_base", 12: "021_bleach_cleanser",
    13: "024_bowl", 14: "025_mug", 15: "035_power_drill",
    16: "036_wood_block", 17: "037_scissors", 18: "040_large_marker",
    19: "051_large_clamp", 20: "052_extra_large_clamp", 21: "061_foam_brick",
}
OBJNAMES = [YCB_CLASSES[i + 1] for i in range(21)]

OBJ_VERTS_PAD = 8000


class YCBDataset(DatasetBase):
    def __init__(self, opt, is_for_train: bool = True):
        super().__init__(opt, is_for_train)
        self._name = "YCBDataset"
        self.data_dir = opt.data_dir
        self.param_dir = os.path.join(opt.data_dir, opt.params_dir)
        self.pic_dir = os.path.join(opt.data_dir, opt.images_dir)
        self.pairs_dir = opt.pairs_dir
        self.image_size = getattr(opt, "image_size", 256)

        if not os.path.exists(self.param_dir):
            raise ValueError(f"param_dir: {self.param_dir} not exist")
        if not os.path.exists(self.pic_dir):
            raise ValueError(f"pic_dir: {self.pic_dir} not exist")

        self.bbx_params = load_pickle_data(
            os.path.join(self.param_dir, "DexYCB-bbx.pkl")
        )
        self.cam_params = load_pickle_data(
            os.path.join(self.param_dir, "valid_video_info.pkl")
        )
        vids_file = "DexYCB_train.pkl" if is_for_train else "DexYCB_test.pkl"
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
            vid_a = os.path.join(*path_a.split("/")[:-1])
            frame_a = int(path_a.split("/")[-1])
            vid_b = os.path.join(*path_b.split("/")[:-1])
            frame_b = int(path_b.split("/")[-1])

        image_a, mano_a = self._get_sample(vid_a, frame_a)
        image_b, mano_b = self._get_sample(vid_b, frame_b)
        return {
            "imageA": image_a, "manoA": mano_a,
            "nameA": os.path.join(vid_a, str(frame_a)),
            "imageB": image_b, "manoB": mano_b,
            "nameB": os.path.join(vid_b, str(frame_b)),
        }

    def _read_annotation(self, vid_id, frame_id, sample):
        intr = sample["intrinsics"]
        cam = np.array(
            [intr["fx"], intr["fy"], intr["ppx"], intr["ppy"]], np.float32
        )
        grasp_id = sample["ycb_grasp_ind"]
        grasp_name = YCB_CLASSES[sample["ycb_ids"][grasp_id]]
        label = np.load(
            os.path.join(
                self.data_dir, "images", vid_id, "labels_{:06d}.npz".format(frame_id)
            )
        )
        pose_y, pose_m = label["pose_y"], label["pose_m"]

        if grasp_name not in self._obj_cache:
            mesh_path = os.path.join(
                self.data_dir, "models", grasp_name, "textured_pre.obj"
            )
            self._obj_cache[grasp_name] = load_obj(mesh_path)["vertices"]
        verts = self._obj_cache[grasp_name]

        pose_obj_list = [
            np.vstack((pose_y[o], np.array([[0, 0, 0, 1]], np.float32)))
            for o in range(len(pose_y))
            if not np.all(pose_y[o] == 0.0)
        ]
        homo = np.concatenate([verts, np.ones_like(verts[:, 2:])], axis=1)
        obj_mesh = (pose_obj_list[grasp_id] @ homo.T)[:3].T

        betas = np.asarray(sample["mano_betas"], np.float32)
        return obj_mesh, pose_m[0].astype(np.float32), betas, cam, grasp_name

    def _get_sample(self, vid_id, frame_id):
        import cv2

        image = cv2.imread(
            os.path.join(self.pic_dir, vid_id, "color_{:06d}.jpg".format(frame_id))
        )
        bbox = self.bbx_params[vid_id]
        bbox = [bbox[0], bbox[1], bbox[2] - bbox[0], bbox[3] - bbox[1]]
        image, trans = augmentation(image, bbox, self.image_size)
        image_chw = normalize_image((image / 255.0)[:, :, ::-1])

        sample = self.cam_params[vid_id]
        obj_mesh_now, pose, betas, cam, grasp_name = self._read_annotation(
            vid_id, frame_id, sample
        )
        obj_mesh = np.zeros((OBJ_VERTS_PAD, 3), np.float32)
        obj_mesh[: obj_mesh_now.shape[0]] = obj_mesh_now

        theta = {
            "cam": cam,
            "trans": trans.astype(np.float32),
            "pose": pose,  # 48 axis-angle/PCA ++ 3 translation
            "shape": betas,
            "vertices_obj": obj_mesh,
            "obj_id": np.int32(OBJNAMES.index(grasp_name)),
        }
        return image_chw, theta
