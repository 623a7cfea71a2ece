"""Checkpoint save / load with the reference's directory naming contract
(port of hoig_tpu/train/checkpoints.py).

Files are `net_epoch_{E}_id_{G|D}.pth` and `opt_epoch_{E}_id_{G|D}.pth`
under checkpoints_dir/name, so the reference's auto-resume scan
(`startswith("net_epoch_")`, epoch = int(name.split('_')[2])) keeps
working. The payload is `torch.save` of state dicts, read back with
`weights_only=True`; a generator also loads from an `.npz` dump.

The networks of a JAX run load too: the JAX package writes the same names
with the suffix `.ckpt`, flax msgpack of the parameter trees (read by
`flax_ckpt`, mapped by `hoig_torch.models.convert`). Only G and D carry
over; optax's Adam state does not, so training cannot resume from a JAX
epoch and says so rather than starting again at epoch 0.
"""

from __future__ import annotations

import os
import re

import torch


def _path(save_dir: str, kind: str, epoch, label: str, suffix: str = ".pth") -> str:
    return os.path.join(save_dir, f"{kind}_epoch_{epoch}_id_{label}{suffix}")


class JaxResumeError(RuntimeError):
    """Training asked to resume from epochs that only a JAX run wrote."""


def _jax_resume_error(save_dir: str, epoch) -> JaxResumeError:
    return JaxResumeError(
        f"{save_dir}: epoch {epoch} is a JAX run's (flax .ckpt files), and this package wrote "
        "no epoch to resume from there. A JAX run's G can be evaluated (eval_torch.py "
        f"--load_epoch {epoch}) or loaded with --load_path "
        f"{_path(save_dir, 'net', epoch, 'G', '.ckpt')}; a JAX optimizer state (optax Adam) "
        "cannot be resumed by this package. Train into another --name or --checkpoints_dir.")


def _load(path: str, device):
    if not os.path.exists(path):
        raise FileNotFoundError(f"Weights file not found. Have you trained a model!? {path}")
    return torch.load(path, map_location=device, weights_only=True)


def _strip_module_prefix(state: dict) -> dict:
    """Drop the `module.` prefix a DistributedDataParallel wrapper adds."""
    return {(k[len("module."):] if k.startswith("module.") else k): v for k, v in state.items()}


def save_checkpoint(save_dir: str, epoch, state) -> None:
    """Write the net and opt files of G and D at `epoch` (may be 'latest')."""
    os.makedirs(save_dir, exist_ok=True)
    torch.save(state.g.state_dict(), _path(save_dir, "net", epoch, "G"))
    torch.save(state.d.state_dict(), _path(save_dir, "net", epoch, "D"))
    torch.save({"opt": state.opt_g.state_dict(), "lr": state.lr_g, "step": state.step},
               _path(save_dir, "opt", epoch, "G"))
    torch.save({"opt": state.opt_d.state_dict(), "lr": state.lr_d},
               _path(save_dir, "opt", epoch, "D"))


def load_checkpoint(save_dir: str, epoch, state, load_optimizers: bool = True, tcfg=None):
    """Restore, in place, a TrainState saved by `save_checkpoint`; G only
    unless `load_optimizers`. Without this package's G file, G comes from a
    JAX run's `net_epoch_{E}_id_G.ckpt` (`tcfg` gives its layout); resuming
    the optimizers from a JAX epoch raises `JaxResumeError`."""
    from hoig_torch.train.trainer import set_lr

    g_path = _path(save_dir, "net", epoch, "G")
    jax_g = _path(save_dir, "net", epoch, "G", ".ckpt")
    if not os.path.exists(g_path) and os.path.exists(jax_g):
        if load_optimizers:
            raise _jax_resume_error(save_dir, epoch)
        load_generator_params(state.g, jax_g, tcfg)
        return state
    device = next(state.g.parameters()).device
    state.g.load_state_dict(_strip_module_prefix(_load(g_path, device)))
    if load_optimizers:
        state.d.load_state_dict(
            _strip_module_prefix(_load(_path(save_dir, "net", epoch, "D"), device)))
        og = _load(_path(save_dir, "opt", epoch, "G"), device)
        od = _load(_path(save_dir, "opt", epoch, "D"), device)
        state.opt_g.load_state_dict(og["opt"])
        state.opt_d.load_state_dict(od["opt"])
        state.step = int(og["step"])
        set_lr(state, float(og["lr"]), float(od["lr"]))
    return state


def load_state_dict_file(path: str, device="cpu") -> dict:
    """A state dict from a torch file (`.pth`, `.pt`) or from its `.npz`
    dump (scripts/convert_weights.py writes one array per key)."""
    if path.endswith(".npz"):
        import numpy as np

        with np.load(path) as arrays:
            return {k: torch.from_numpy(arrays[k]).to(device) for k in arrays.files}
    return _load(path, device)


def _flax_params(path: str) -> dict:
    from hoig_torch.train.flax_ckpt import numpy_tree, read_flax_checkpoint

    if not os.path.exists(path):
        raise FileNotFoundError(f"Weights file not found. Have you trained a model!? {path}")
    return numpy_tree(read_flax_checkpoint(path))


def load_generator_params(g_model: torch.nn.Module, load_path: str, tcfg=None) -> torch.nn.Module:
    """Eval-style G-only restore: from a generator state dict (this
    package's `net_epoch_*_id_G.pth`, the reference's, whose keys are the
    same, or an `.npz` dump of either), or from the JAX package's flax
    `.ckpt`, mapped by `generator_state_dict_from_flax` for the layout of
    `tcfg` (a TrainConfig)."""
    device = next(g_model.parameters()).device
    if load_path.endswith(".ckpt"):
        from hoig_torch.models.convert import generator_state_dict_from_flax

        if tcfg is None:
            raise ValueError("loading a flax .ckpt generator needs the TrainConfig (its layout)")
        state = generator_state_dict_from_flax(_flax_params(load_path), tcfg)
    else:
        state = _strip_module_prefix(load_state_dict_file(load_path, device))
    g_model.load_state_dict(state)
    return g_model


def load_discriminator_params(d_model: torch.nn.Module, load_path: str,
                              n_layers: int = 4) -> torch.nn.Module:
    """D from a state dict file (`.pth`, `.npz`) or the JAX package's flax
    `.ckpt` of a PatchGAN with `n_layers` stride-2 blocks."""
    if load_path.endswith(".ckpt"):
        from hoig_torch.models.convert import discriminator_state_dict_from_flax

        state = discriminator_state_dict_from_flax(_flax_params(load_path), n_layers)
    else:
        state = _strip_module_prefix(
            load_state_dict_file(load_path, next(d_model.parameters()).device))
    d_model.load_state_dict(state)
    return d_model


def scan_latest_epoch(save_dir: str) -> int:
    """Auto-resume scan. Only epochs whose COMPLETE file set (net + opt for
    G and D) is present count: a run killed mid-save leaves a torn epoch
    that would break every later auto-resume, so the scan falls back to the
    newest complete epoch. A directory whose only complete epochs are a JAX
    run's (`.ckpt`) raises `JaxResumeError` instead of returning 0, which
    would start training again from scratch."""
    if not os.path.isdir(save_dir):
        return 0
    epochs = set()
    for f in os.listdir(save_dir):
        m = re.match(r"net_epoch_(\d+)_", f)
        if m:
            epochs.add(int(m.group(1)))

    def newest(suffix):
        return max((e for e in epochs
                    if all(os.path.exists(_path(save_dir, kind, e, net, suffix))
                           for kind in ("net", "opt") for net in ("G", "D"))), default=0)

    latest = newest(".pth")
    if latest == 0 and newest(".ckpt"):
        raise _jax_resume_error(save_dir, newest(".ckpt"))
    return latest
