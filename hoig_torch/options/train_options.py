"""Training flags (port of hoig_tpu/options/train_options.py; reference
options/train_options.py:9-37)."""

from __future__ import annotations

import os

from hoig_torch.options.base_options import BaseOptions


class TrainOptions(BaseOptions):
    def initialize(self):
        BaseOptions.initialize(self)
        p = self._parser
        p.add_argument("--intervals", type=int, default=10)
        p.add_argument("--n_threads_train", default=4, type=int)
        p.add_argument("--num_iters_validate", default=1, type=int)
        p.add_argument("--print_freq_s", type=int, default=60)
        p.add_argument("--display_freq_s", type=int, default=300)
        p.add_argument("--save_latest_freq_s", type=int, default=3600)
        p.add_argument("--bg_both", action="store_true")
        p.add_argument("--use_vgg", action="store_true")
        p.add_argument("--mask_bce", action="store_true")
        p.add_argument("--nepochs_no_decay", type=int, default=10)
        p.add_argument("--nepochs_decay", type=int, default=20)
        p.add_argument("--train_G_every_n_iterations", type=int, default=1)
        p.add_argument("--final_lr", type=float, default=0.000002)
        p.add_argument("--lr_G", type=float, default=0.0002)
        p.add_argument("--G_adam_b1", type=float, default=0.5)
        p.add_argument("--G_adam_b2", type=float, default=0.999)
        p.add_argument("--lr_D", type=float, default=0.0002)
        p.add_argument("--D_adam_b1", type=float, default=0.5)
        p.add_argument("--D_adam_b2", type=float, default=0.999)
        p.add_argument("--lambda_D_prob", type=float, default=1)
        p.add_argument("--lambda_rec", type=float, default=10)
        p.add_argument("--lambda_tsf", type=float, default=10)
        p.add_argument("--lambda_mask", type=float, default=0.1)
        p.add_argument("--lambda_mask_smooth", type=float, default=1e-5)
        p.add_argument(
            "--local_rank", default=int(os.getenv("LOCAL_RANK", -1)), type=int
        )
        # how many devices the data is split over (0 = all). The reference's
        # --batch_size is per GPU (8 DDP processes x batch 4 = global 32,
        # scripts/train_hov3_ddp.sh:31,52). One process drives one card
        # here: 0 or 1 (hoig_torch/parallel/mesh.py refuses more)
        p.add_argument("--num_data_devices", type=int, default=0)
        self.is_train = True

    def parse(self, args=None):
        from hoig_torch.parallel import num_data_devices

        opt = BaseOptions.parse(self, args)
        num_data_devices(opt)
        return opt
