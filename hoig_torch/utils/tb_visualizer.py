"""Training observability (port of hoig_tpu/utils/tb_visualizer.py;
reference utils/tb_visualizer.py).

Scalars and image panels go to tensorboardX where it is installed, and are
always mirrored to `summary.json` and the text log `loss_log2.txt`, so a
machine without tensorboard keeps the record. Images are written as PNG by
hoig_torch.utils.util.save_image (no cv2).
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

from hoig_torch.utils.util import save_image


class TBVisualizer:
    def __init__(self, opt):
        self._opt = opt
        self._save_path = os.path.join(opt.checkpoints_dir, opt.name)
        os.makedirs(self._save_path, exist_ok=True)
        self._log_path = os.path.join(self._save_path, "loss_log2.txt")
        self._summary = {}
        self._summary_path = os.path.join(self._save_path, "summary.json")
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            self._writer = None
        else:
            self._writer = SummaryWriter(self._save_path)
        with open(self._log_path, "a") as fp:
            fp.write(f"================ Training Loss ({time.strftime('%c')}) ================\n")

    def close(self):
        if self._writer is not None:
            self._writer.close()
            self._writer = None

    def display_current_results(self, visuals, it, is_train, save_visuals=False):
        for label, image in visuals.items():
            tag = f"{'Train' if is_train else 'Test'}/{label}"
            if self._writer is not None:
                self._writer.add_image(tag, np.asarray(image), it, dataformats="HWC")
            if save_visuals:
                vdir = os.path.join(self._save_path, "event_imgs", label)
                os.makedirs(vdir, exist_ok=True)
                save_image(np.asarray(image), os.path.join(vdir, f"{it:08d}.png"))

    def plot_scalars(self, scalars, it, is_train):
        for label, scalar in scalars.items():
            sum_name = f"{'Train' if is_train else 'Test'}/{label}"
            if self._writer is not None:
                self._writer.add_scalar(sum_name, float(scalar), it)
            self._summary.setdefault(sum_name, []).append([it, float(scalar)])
        with open(self._summary_path, "w") as fp:
            json.dump(self._summary, fp)

    def print_current_train_errors(self, epoch, i, iters_per_epoch, errors, t, visuals_were_stored):
        visuals_info = "v" if visuals_were_stored else ""
        message = (f"{time.strftime('%c')} (T{visuals_info}, epoch: {epoch}, it: {i}/"
                   f"{iters_per_epoch}, t/smpl: {t:.3f}s) ")
        for k, v in errors.items():
            message += f"{k}:{float(v):.3f} "
        self._log(message)

    def print_current_validate_errors(self, epoch, errors, t):
        message = f"{time.strftime('%c')} (V, epoch: {epoch}, time_to_val: {t:.3f}s) "
        for k, v in errors.items():
            message += f"{k}:{float(v):.3f} "
        self._log(message)

    def save_images(self, visuals):
        for label, image_numpy in visuals.items():
            save_path = os.path.join(self._save_path, "samples", f"{label}.png")
            os.makedirs(os.path.dirname(save_path), exist_ok=True)
            save_image(np.asarray(image_numpy), save_path)

    def _log(self, message: str) -> None:
        print(message)
        with open(self._log_path, "a") as fp:
            fp.write(f"{message}\n")
