"""Training driver of the PyTorch/CUDA port (the counterpart of train.py).

    python train_torch.py --dataset_mode synthetic --batch_size 4 --bf16 ...
    python train_torch.py --device cpu ...   # the plain PyTorch path, no card
    torchrun --nproc_per_node 8 train_torch.py --batch_size 4 ...   # 8 cards

One process drives one card (CUDA unless --device cpu; without a card it
raises). Under torchrun the processes form one data-parallel run
(hoig_torch.parallel): NCCL on the cards, gloo on the CPU; --batch_size is
per card, each process reads its own shard of every epoch, the step averages
the gradients, and rank 0 alone prints, shows visuals and saves. The loop is
train.py's: time-based console prints, visual panels and latest-checkpoint
saves; a validation pass at every display; a checkpoint at the end of every
epoch; linear LR decay after nepochs_no_decay.
"""

from __future__ import annotations

import os
import time
from collections import OrderedDict


def setup_seed(seed: int = 8):
    """The reference's setup_seed (train.py:9-18): Python, numpy and torch."""
    import random

    import numpy as np
    import torch

    random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


class Train:
    def __init__(self, argv=None):
        from hoig_torch.data.loader import CustomDatasetDataLoader
        from hoig_torch.options.train_options import TrainOptions
        from hoig_torch.parallel import init_from_env, num_data_devices, process_is_primary, rank
        from hoig_torch.train.model_api import ModelsFactory
        from hoig_torch.utils.tb_visualizer import TBVisualizer

        self._opt = TrainOptions().parse(argv)
        init_from_env(self._opt.device)
        self._world = num_data_devices(self._opt)
        self._primary = process_is_primary()
        shards = dict(use_ddp=self._world > 1, num_shards=self._world, shard_index=rank())
        data_loader_train = CustomDatasetDataLoader(self._opt, is_for_train=True, **shards)
        data_loader_test = CustomDatasetDataLoader(self._opt, is_for_train=False, **shards)
        self._dataset_train = data_loader_train.load_data()
        self._dataset_test = data_loader_test.load_data()
        self._dataset_train_size = len(data_loader_train)
        self._dataset_test_size = len(data_loader_test)
        print("#train video clips = %d" % self._dataset_train_size)
        print("#test video clips = %d" % self._dataset_test_size)

        env = None
        if self._opt.dataset_mode == "synthetic":
            from hoig_torch.geometry.conditioning import ConditioningConfig

            env = dict(data_loader_train.dataset.environment(self._opt.device),
                       ccfg=ConditioningConfig(image_size=self._opt.image_size), is_ycb=False)
        self._model = ModelsFactory.get_by_name(self._opt.model, self._opt, env=env)
        self._tb_visualizer = TBVisualizer(self._opt)
        try:
            self._train()
        finally:
            self._tb_visualizer.close()

    @property
    def model(self):
        return self._model

    def _train(self):
        from hoig_torch.parallel import coordination_barrier, per_process_batch_size

        opt = self._opt
        # the counters count the global batch, as one JAX host's run does
        self._global_batch = per_process_batch_size(opt) * self._world
        self._total_steps = opt.load_epoch * self._dataset_train_size
        self._iters_per_epoch = self._dataset_train_size / self._global_batch
        self._last_display_time = None
        self._last_save_latest_time = None
        self._last_print_time = time.time()

        max_epoch = opt.nepochs_no_decay + opt.nepochs_decay
        for i_epoch in range(opt.load_epoch + 1, max_epoch + 1):
            epoch_start = time.time()
            self._train_epoch(i_epoch)

            if self._primary:
                print("saving the model at the end of epoch %d, iters %d"
                      % (i_epoch, self._total_steps))
                self._model.save(i_epoch)
                dt = time.time() - epoch_start
                print("End of epoch %d / %d \t Time Taken: %d sec (%d min or %d h)"
                      % (i_epoch, max_epoch, dt, dt / 60, dt / 3600))
            # no rank starts the next epoch's all-reduces while rank 0 writes
            coordination_barrier(f"epoch_{i_epoch}_saved")
            if i_epoch > opt.nepochs_no_decay:
                self._model.update_learning_rate()

    def _train_epoch(self, i_epoch):
        opt = self._opt
        self._model.set_train()
        self._dataset_train.set_epoch(i_epoch)
        for i_batch, batch in enumerate(self._dataset_train):
            iter_start = time.time()
            do_visuals = (self._last_display_time is None
                          or time.time() - self._last_display_time > opt.display_freq_s)
            do_print = time.time() - self._last_print_time > opt.print_freq_s or do_visuals

            self._model.set_input(batch)
            trainable = ((i_batch + 1) % opt.train_G_every_n_iterations == 0) or do_visuals
            self._model.optimize_parameters(keep_data_for_visuals=do_visuals and self._primary,
                                            trainable=trainable)

            self._total_steps += self._global_batch
            # the errors are device scalars: reading them waits for the
            # device, so only the print and display gates read them
            if self._primary and do_print:
                errors = self._model.get_current_errors()
                t = (time.time() - iter_start) / self._global_batch
                self._tb_visualizer.print_current_train_errors(
                    i_epoch, i_batch, self._iters_per_epoch, errors, t, do_visuals)
                self._last_print_time = time.time()
            if self._primary and do_visuals:
                self._display_visualizer_train(self._total_steps)
                self._display_visualizer_val(i_epoch, self._total_steps)
                self._last_display_time = time.time()
            if self._primary and (self._last_save_latest_time is None
                                  or time.time() - self._last_save_latest_time
                                  > opt.save_latest_freq_s):
                print("saving the latest model (epoch %d, total_steps %d)"
                      % (i_epoch, self._total_steps))
                self._model.save(i_epoch)
                self._last_save_latest_time = time.time()

    def _display_visualizer_train(self, total_steps):
        self._tb_visualizer.display_current_results(self._model.get_current_visuals(),
                                                    total_steps, is_train=True)
        self._tb_visualizer.plot_scalars(self._model.get_current_errors(), total_steps,
                                         is_train=True)
        self._tb_visualizer.plot_scalars(self._model.get_current_scalars(), total_steps,
                                         is_train=True)

    def _display_visualizer_val(self, i_epoch, total_steps):
        val_start = time.time()
        self._model.set_eval()
        val_errors = OrderedDict()
        self._dataset_test.set_epoch(i_epoch)
        n_val = 0
        for i_val, val_batch in enumerate(self._dataset_test):
            if i_val == self._opt.num_iters_validate:
                break
            self._model.set_input(val_batch)
            self._model.forward(keep_data_for_visuals=(i_val == 0))
            for k, v in self._model.get_current_errors().items():
                val_errors[k] = val_errors.get(k, 0) + v
            n_val += 1
        # the mean over the batches seen: a test split smaller than
        # num_iters_validate must not deflate the losses
        for k in val_errors:
            val_errors[k] /= max(n_val, 1)
        self._tb_visualizer.print_current_validate_errors(i_epoch, val_errors,
                                                          time.time() - val_start)
        self._tb_visualizer.plot_scalars(val_errors, total_steps, is_train=False)
        self._tb_visualizer.display_current_results(self._model.get_current_visuals(),
                                                    total_steps, is_train=False)
        self._model.set_train()


if __name__ == "__main__":
    from hoig_torch.parallel import shutdown

    setup_seed()
    try:
        Train()
    finally:
        shutdown()
