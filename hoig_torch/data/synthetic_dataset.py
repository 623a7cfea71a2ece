"""Synthetic dataset mode: the full sample contract with no assets (port of
hoig_tpu/data/synthetic_dataset.py).

Registered as dataset_mode 'synthetic'; its samples have HOv3Dataset's
layout and come from the deterministic fixture environment, so the drivers
run anywhere. Sample i is drawn from seeds of i alone: the same item is
bit-equal in both packages.
"""

from __future__ import annotations

import numpy as np

from hoig_torch.data.dataset_base import DatasetBase
from hoig_torch.data.synthetic import host_environment, synthetic_environment, synthetic_theta


class SyntheticDataset(DatasetBase):
    def __init__(self, opt, is_for_train: bool = True):
        super().__init__(opt, is_for_train)
        self._name = "SyntheticDataset"
        self.image_size = getattr(opt, "image_size", 256)
        self.num_objects = getattr(opt, "synthetic_num_objects", 2)
        self._obj_verts = host_environment(self.num_objects, self.image_size, 0)[2]
        self._n = getattr(opt, "synthetic_size", 64) * max(1, getattr(opt, "num_repeats", 1))

    def environment(self, device="cuda") -> dict:
        """The fixture environment on `device` (see synthetic_environment)."""
        return synthetic_environment(self.num_objects, self.image_size, device=device)

    def __len__(self):
        return self._n

    def __getitem__(self, index):
        rng = np.random.RandomState(index)
        s = self.image_size
        theta_a = synthetic_theta(1, self._obj_verts, seed=index * 2 + 1, image_size=s)
        theta_b = synthetic_theta(1, self._obj_verts, seed=index * 2 + 2, image_size=s)
        theta_b["obj_id"] = theta_a["obj_id"]
        squeeze = lambda d: {k: v[0] for k, v in d.items()}
        return {
            "imageA": (rng.rand(3, s, s) * 2 - 1).astype(np.float32),
            "maskA": (rng.rand(1, s, s) > 0.5).astype(np.float32),
            "manoA": squeeze(theta_a),
            "nameA": f"synthetic/{index}_a",
            "imageB": (rng.rand(3, s, s) * 2 - 1).astype(np.float32),
            "maskB": (rng.rand(1, s, s) > 0.5).astype(np.float32),
            "manoB": squeeze(theta_b),
            "nameB": f"synthetic/{index}_b",
        }
