"""Process layout of a run (one process, one card until DDP lands)."""

from hoig_torch.parallel.mesh import num_data_devices, per_process_batch_size, process_is_primary
