"""The one-process form of hoig_tpu/parallel/mesh.py's batch and rank helpers.

One process drives one card: the world size is 1 and this process is the
primary. Data parallelism over several cards (torch.distributed) is not
ported yet, so `--num_data_devices` above 1 is refused rather than ignored.
"""

from __future__ import annotations

WORLD_SIZE = 1


def num_data_devices(opt=None) -> int:
    """How many devices the data is split over (--num_data_devices, 0 = all):
    1, the one card of this process."""
    n = int(getattr(opt, "num_data_devices", 0) or 0)
    if n > WORLD_SIZE:
        raise ValueError(f"--num_data_devices {n}: this port runs on one device per run "
                         "(data parallelism is not ported yet); pass 0 or 1")
    return WORLD_SIZE


def per_process_batch_size(opt) -> int:
    """Samples per step for this process: --batch_size is per device (the
    reference's DDP semantics), times the devices this process feeds while
    training; eval keeps --batch_size as it is."""
    b = int(opt.batch_size)
    if getattr(opt, "is_train", False):
        return b * num_data_devices(opt)
    return b


def process_is_primary() -> bool:
    """Rank-0 gating of logs, visuals and checkpoints: the one process is."""
    return True
