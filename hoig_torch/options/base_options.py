"""Argparse flag surface (port of hoig_tpu/options/base_options.py;
reference options/base_options.py:11-137): the same flag names and
defaults, the opt_train.txt / opt_test.txt dump, unknown flags accepted and
ignored, and the auto-resume scan over `net_epoch_*` files. The JAX
package's `--platform` is `--device` here: 'cuda' unless the caller names
the CPU, checked when the flags are parsed. `--gpu_ids` is kept for the
scripts' sake and selects nothing.
"""

from __future__ import annotations

import argparse
import os

from hoig_torch.ops._cuda import resolve_device
from hoig_torch.parallel import process_is_primary


class BaseOptions:
    def __init__(self):
        self._parser = argparse.ArgumentParser()
        self._initialized = False
        self.is_train = False

    def initialize(self):
        p = self._parser
        p.add_argument("--checkpoints_dir", type=str, default="./outputs/checkpoints/")
        p.add_argument("--data_dir", type=str, default="./dataset/STB/")
        p.add_argument("--params_dir", type=str, default="STB_mano_param.pkl")
        p.add_argument("--images_dir", type=str, default="")
        p.add_argument("--pairs_dir", type=str, default="")
        p.add_argument("--dataset_mode", type=str, default="STB")
        p.add_argument("--cache_dir", type=str, default="./dataset/STB/train.pkl")
        p.add_argument("--data_split", type=str, default="train")
        p.add_argument("--njoints", type=int, default=21)
        p.add_argument("--num_repeats", type=int, default=1)
        p.add_argument("--map_name", type=str, default="uv_seg")
        p.add_argument("--uv_mapping", type=str, default=["assets/MANO_UV_right.obj"])
        p.add_argument("--hmr_model", type=str, default=None)
        p.add_argument("--mano_model", type=str, default="assets/smplx/models/")
        p.add_argument("--load_epoch", type=int, default=-1)
        p.add_argument("--load_path", type=str, default=None)
        p.add_argument("--batch_size", type=int, default=1)
        p.add_argument("--time_step", type=int, default=10)
        p.add_argument("--tex_size", type=int, default=3)
        p.add_argument("--image_size", type=int, default=256)
        p.add_argument("--repeat_num", type=int, default=6)
        p.add_argument("--cond_nc", type=int, default=2)
        p.add_argument("--gpu_ids", type=str, default="0")
        p.add_argument("--model", type=str, default="trainer")
        p.add_argument("--name", type=str, default="trainer")
        p.add_argument("--gen_name", type=str, default="generator_spade_attn")
        p.add_argument("--norm_type", type=str, default="instance")
        p.add_argument("--use_occulsion_map", action="store_true", default=True)
        p.add_argument("--n_threads_test", default=2, type=int)
        p.add_argument("--serial_batches", action="store_true")
        p.add_argument("--debug", action="store_true", default=False)
        p.add_argument("--use_spade", action="store_true")
        # TPU-framework additions (all optional; scripts need not pass them)
        p.add_argument("--obj_dir", type=str, default="assets/obj",
                       help="YCB object mesh root (reference hardcodes it)")
        p.add_argument("--sem_hand", type=str, default="assets/semantics_hand.pkl")
        p.add_argument("--vgg_weights", type=str, default=None,
                       help="torchvision vgg19 state-dict (.pth/.npz); random "
                            "features if absent (refused for real-data training)")
        p.add_argument("--synthetic_data", action="store_true",
                       help="run on the synthetic fixture environment")
        p.add_argument("--synthetic_size", type=int, default=64,
                       help="samples per epoch in synthetic mode")
        p.add_argument("--synthetic_num_objects", type=int, default=2)
        p.add_argument("--conv_dim", type=int, default=64,
                       help="base conv width (reference hardcodes 64)")
        p.add_argument("--bf16", action="store_true",
                       help="run network compute in bfloat16")
        p.add_argument("--no_remat", action="store_true",
                       help="disable activation rematerialization")
        p.add_argument("--remat_bottleneck", action="store_true",
                       help="force rematerialization of the 1/8-res "
                            "bottleneck blocks too (lowest memory). Default: "
                            "full remat in fp32; under --bf16 the bottleneck "
                            "activations are kept (faster, fits HBM)")
        p.add_argument("--device", type=str, default="cuda",
                       help="torch device of the run: 'cuda' (the default; "
                            "raises where there is no card) or 'cpu' (the "
                            "plain PyTorch versions of the kernels)")
        p.add_argument("--corner_engine", type=str, default="auto",
                       choices=["auto", "gather", "shift", "pallas"],
                       help="flow-attention corner engine: 'gather' (row "
                            "gathers), 'shift' (bounded shifts through the "
                            "local_combine kernel), 'pallas' (the fused "
                            "attention kernels of ops/attn_fused.py). 'auto' = "
                            "shift under --bf16, gather otherwise")
        self._initialized = True

    def parse(self, args=None):
        if not self._initialized:
            self.initialize()
        # accept-and-ignore unknown flags (e.g. eval_hov3.sh passes the
        # undefined --eval_pairs, scripts/eval_hov3.sh:29 — the reference
        # would crash; we keep the script contract instead)
        self._opt, unknown = self._parser.parse_known_args(args)
        if unknown:
            print(f"[options] ignoring unknown flags: {unknown}")

        self._opt.is_train = self.is_train
        resolve_device(self._opt.device)
        self._set_and_check_load_epoch()

        opts = vars(self._opt)
        # under torchrun, rank 0 alone prints and writes the options
        if process_is_primary():
            self._print(opts)
            self._save(opts)
        return self._opt

    def _set_and_check_load_epoch(self):
        from hoig_torch.train.checkpoints import scan_latest_epoch

        models_dir = os.path.join(self._opt.checkpoints_dir, self._opt.name)
        if os.path.exists(models_dir):
            if self._opt.load_epoch == -1:
                self._opt.load_epoch = scan_latest_epoch(models_dir)
            # explicit epochs are validated at load time
        else:
            if self._opt.load_epoch >= 1:
                raise FileNotFoundError("Model for epoch %i not found" % self._opt.load_epoch)
            self._opt.load_epoch = 0

    @staticmethod
    def _print(args):
        print("------------ Options -------------")
        for k, v in sorted(args.items()):
            print(f"{k}: {v}")
        print("-------------- End ----------------")

    def _save(self, args):
        expr_dir = os.path.join(self._opt.checkpoints_dir, self._opt.name)
        os.makedirs(expr_dir, exist_ok=True)
        name = "opt_%s.txt" % ("train" if self.is_train else "test")
        with open(os.path.join(expr_dir, name), "wt") as fp:
            fp.write("------------ Options -------------\n")
            for k, v in sorted(args.items()):
                fp.write(f"{k}: {v}\n")
            fp.write("-------------- End ----------------\n")
