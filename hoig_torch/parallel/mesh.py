"""Data parallelism over torch.distributed (port of hoig_tpu/parallel/mesh.py).

One process drives one card, as the reference trains (`torchrun
--nproc_per_node N train_torch.py ...`, scripts/train_hov3_ddp_torch.sh).
`init_from_env` joins the process group that torchrun's environment
describes (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR / MASTER_PORT): NCCL
when the run's device is CUDA, gloo when it is the CPU. Without that
environment nothing is set up: the world is this one process, no collective
runs and the train step is the one-card step.

`DataParallel` averages gradients by hand rather than through
DistributedDataParallel. The G loss runs D inside it and is differentiated
with respect to G alone (`backward(inputs=...)`), so a DDP-wrapped D would
wait for gradients that never come. Each network's gradients live in one
flat buffer (the parameters' `.grad` are views of it); after each backward
the buffer goes through one all_reduce(SUM) and a divide by the world size,
G's then D's, in the same order on every rank. Every loss of the port is a
mean of equal-sized per-sample means, so the ranks' average is the gradient
of the global batch, as in the JAX package, where XLA reduces the gradients
inside the jitted step. What the hosts must agree on (the D gate, barriers)
goes over a gloo group beside the NCCL one, so that no host waits on the
card for it.
"""

from __future__ import annotations

import collections
import datetime
import os

import torch
import torch.distributed as dist

# one gloo group per default process group, for host-side agreement
_HOST_GROUPS: dict = {}


def _env_world() -> bool:
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def init_from_env(device) -> bool:
    """Join the process group of torchrun's environment, once per process:
    NCCL for a CUDA run (on the card LOCAL_RANK names), gloo for the CPU.
    Returns whether a process group is up; without the environment, none is."""
    if is_distributed():
        return True
    if not _env_world():
        return False
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method="env://")
    return True


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    if is_distributed():
        _HOST_GROUPS.pop(dist.group.WORLD, None)
        dist.destroy_process_group()


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """Processes of the run: the process group's size, or before it is set
    up the size torchrun's environment announces; 1 without either."""
    if is_distributed():
        return dist.get_world_size()
    return int(os.environ["WORLD_SIZE"]) if _env_world() else 1


def rank() -> int:
    if is_distributed():
        return dist.get_rank()
    return int(os.environ["RANK"]) if _env_world() else 0


def num_data_devices(opt=None) -> int:
    """How many cards the data is split over: one per process, so the world
    size. --num_data_devices (0 = all) other than that is refused."""
    n = int(getattr(opt, "num_data_devices", 0) or 0)
    world = world_size()
    if n not in (0, world):
        raise ValueError(f"--num_data_devices {n}: this run has {world} process(es), one card "
                         f"each; pass 0 or {world} (start N processes with torchrun "
                         "--nproc_per_node N for N cards)")
    return world


def per_process_batch_size(opt) -> int:
    """Samples per step for this process: --batch_size, per card as in the
    reference's DDP runs (8 processes x batch 4 = global batch 32). Each
    process feeds one card, so training and eval alike keep it as it is."""
    return int(opt.batch_size)


def process_is_primary() -> bool:
    """Rank-0 gating of prints, visuals and checkpoints."""
    return rank() == 0


def host_group():
    """The gloo group of this process group (the default group itself when
    that is gloo): collectives on CPU tensors that never wait on the card."""
    world = dist.group.WORLD
    if dist.get_backend() == "gloo":
        return world
    if world not in _HOST_GROUPS:
        _HOST_GROUPS[world] = dist.new_group(backend="gloo")
    return _HOST_GROUPS[world]


def coordination_barrier(name: str, timeout_ms: int = 1_800_000) -> None:
    """Rendezvous every process without a device collective (over gloo),
    waiting up to timeout_ms; a no-op in a one-process run. `name` labels the
    barrier in the error a timed-out rank raises."""
    if not is_distributed():
        return
    try:
        dist.monitored_barrier(group=host_group(),
                               timeout=datetime.timedelta(milliseconds=timeout_ms))
    except RuntimeError as e:
        raise RuntimeError(f"coordination barrier '{name}': {e}") from e


def local_batch_slice(global_batch_size: int) -> slice:
    """This process's contiguous share of a global batch
    (DistributedSampler's per-process shard)."""
    per = global_batch_size // world_size()
    start = rank() * per
    return slice(start, start + per)


def _grad_views(net: torch.nn.Module) -> torch.Tensor:
    """One flat zeroed buffer for the gradients of net's trainable
    parameters, each parameter's `.grad` set to a view of it with the
    parameter's own strides (backward then adds into it in place)."""
    params = [p for p in net.parameters() if p.requires_grad]
    dtypes = {p.dtype for p in params}
    if len(dtypes) != 1:
        raise ValueError(f"parameters of several dtypes {sorted(map(str, dtypes))}")
    buf = torch.zeros(sum(p.numel() for p in params), dtype=params[0].dtype,
                      device=params[0].device)
    off = 0
    for p in params:
        if not (p.is_contiguous() or p.is_contiguous(memory_format=torch.channels_last)):
            raise ValueError(f"a parameter of shape {tuple(p.shape)} with strides {p.stride()}")
        p.grad = buf.as_strided(p.shape, p.stride(), off)
        off += p.numel()
    return buf


class DataParallel:
    """Gradient, metric and gate agreement for one TrainState over the
    process group; `make_train_step(..., sync=DataParallel(state))` calls it.

    On construction, rank 0's parameters and buffers of G and D are
    broadcast to every rank (as DistributedDataParallel does), and each
    network's gradients are laid into one flat buffer. `collectives` counts
    the collectives the step launched, by name."""

    def __init__(self, state):
        if not is_distributed():
            raise RuntimeError("DataParallel needs a process group (init_from_env)")
        self.world = dist.get_world_size()
        self._host = host_group()
        self.collectives: collections.Counter = collections.Counter()
        with torch.no_grad():
            for net in (state.g, state.d):
                for t in [*net.parameters(), *net.buffers()]:
                    dist.broadcast(t, src=0)
        self.flat = {"g": _grad_views(state.g), "d": _grad_views(state.d)}

    def agree(self, flag: bool) -> bool:
        """Rank 0's flag on every rank (a gloo broadcast of a CPU tensor)."""
        t = torch.tensor([int(bool(flag))], dtype=torch.uint8)
        dist.broadcast(t, src=0, group=self._host)
        self.collectives["broadcast_gate"] += 1
        return bool(t.item())

    def zero_grad(self, net: str) -> None:
        """Zero the gradients of net ("g" or "d") before its backward."""
        self.flat[net].zero_()

    def reduce_grads(self, net: str) -> None:
        """Average net's gradients over the ranks: one all_reduce(SUM) of the
        flat buffer, then a divide by the world size."""
        dist.all_reduce(self.flat[net])
        self.collectives[f"all_reduce_{net}"] += 1
        self.flat[net].div_(self.world)

    def mean_metrics(self, metrics: dict) -> dict:
        """The step's scalars averaged over the ranks (the global-batch means):
        one all_reduce of them stacked, which leaves the host free on NCCL."""
        keys = list(metrics)
        stacked = torch.stack([metrics[k].float().reshape(()) for k in keys])
        dist.all_reduce(stacked)
        self.collectives["all_reduce_metrics"] += 1
        stacked.div_(self.world)
        return {k: stacked[i].to(metrics[k].dtype) for i, k in enumerate(keys)}
