"""Process layout of a run: one process per card, joined by torch.distributed
when torchrun starts several."""

from hoig_torch.parallel.mesh import (
    DataParallel,
    coordination_barrier,
    init_from_env,
    is_distributed,
    local_batch_slice,
    num_data_devices,
    per_process_batch_size,
    process_is_primary,
    rank,
    shutdown,
    world_size,
)
