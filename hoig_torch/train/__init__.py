"""Training: the GAN step, its losses and checkpoints."""

from hoig_torch.train.checkpoints import (
    load_checkpoint,
    load_generator_params,
    save_checkpoint,
    scan_latest_epoch,
)
from hoig_torch.train.trainer import (
    TrainConfig,
    TrainState,
    build_networks,
    composite,
    decay_lr,
    generator_kwargs,
    init_state,
    make_train_step,
)
