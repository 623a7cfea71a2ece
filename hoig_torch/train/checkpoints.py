"""Checkpoint save / load with the reference's directory naming contract
(port of hoig_tpu/train/checkpoints.py).

Files are `net_epoch_{E}_id_{G|D}.pth` and `opt_epoch_{E}_id_{G|D}.pth`
under checkpoints_dir/name, so the reference's auto-resume scan
(`startswith("net_epoch_")`, epoch = int(name.split('_')[2])) keeps
working. The payload is `torch.save` of state dicts, read back with
`weights_only=True`; a generator also loads from an `.npz` dump.

A JAX run's epochs load too: the JAX package writes the same names with the
suffix `.ckpt`, flax msgpack of the parameter trees and of optax's Adam
state (read by `flax_ckpt`; the parameters mapped by
`hoig_torch.models.convert`, the Adam moments by `optax_state`). Training
resumes from such an epoch as from its own: auto-resume, --load_epoch and
`load_checkpoint` take whichever kind an epoch has complete, this package's
`.pth` first.
"""

from __future__ import annotations

import os
import re

import torch


def _path(save_dir: str, kind: str, epoch, label: str, suffix: str = ".pth") -> str:
    return os.path.join(save_dir, f"{kind}_epoch_{epoch}_id_{label}{suffix}")


_FILES = tuple((kind, net) for kind in ("net", "opt") for net in ("G", "D"))


def _complete(save_dir: str, epoch, suffix: str, files=_FILES) -> bool:
    return all(os.path.exists(_path(save_dir, kind, epoch, net, suffix)) for kind, net in files)


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
    """Restore, in place, a TrainState saved by `save_checkpoint` or by the
    JAX package (its `.ckpt` files, read when this package's own files of the
    epoch are not all there; `tcfg` gives G's layout); G only unless
    `load_optimizers`."""
    from hoig_torch.train.trainer import set_lr

    files = _FILES if load_optimizers else (("net", "G"),)
    if not _complete(save_dir, epoch, ".pth", files) and _complete(save_dir, epoch, ".ckpt",
                                                                   files):
        return _load_jax_epoch(save_dir, epoch, state, load_optimizers, tcfg)
    g_path = _path(save_dir, "net", epoch, "G")
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


def _load_jax_epoch(save_dir: str, epoch, state, load_optimizers: bool, tcfg):
    files = [("net", "G")] + ([("net", "D"), ("opt", "G"), ("opt", "D")] if load_optimizers
                              else [])
    return load_jax_state(state, tcfg, *(_flax_params(_path(save_dir, kind, epoch, net, ".ckpt"))
                                         for kind, net in files))


def load_jax_state(state, tcfg, net_g: dict, net_d: dict | None = None, opt_g: dict | None = None,
                   opt_d: dict | None = None):
    """A JAX run's trees (numpy leaves, as its `.ckpt` files hold them) into
    `state`, in place: G (laid out by `tcfg`) and, with the others, D through
    the parameter maps, optax's Adam moments into each optimizer by its own
    `load_state_dict` (Adam's step where torch keeps it), the learning rates
    and the step counter. opt_g / opt_d: `{"opt": {"0": {"count", "mu",
    "nu"}, "1": {}}, "lr"[, "step"]}`."""
    from hoig_torch.models.convert import (discriminator_mapping, discriminator_state_dict_from_flax,
                                           generator_mapping, generator_state_dict_from_flax)
    from hoig_torch.train.optax_state import adam_state_dict_from_optax
    from hoig_torch.train.trainer import set_lr

    if tcfg is None:
        raise ValueError("loading a flax generator needs the TrainConfig (its layout)")
    state.g.load_state_dict(generator_state_dict_from_flax(net_g, tcfg))
    if net_d is None:
        return state
    state.d.load_state_dict(discriminator_state_dict_from_flax(net_d, 4))
    for opt, tree, module, mapping in (
            (state.opt_g, opt_g, state.g, generator_mapping(tcfg.gen_name, tcfg.repeat_num)),
            (state.opt_d, opt_d, state.d, discriminator_mapping(4))):
        opt.load_state_dict(adam_state_dict_from_optax(tree["opt"], opt, module, mapping))
    state.step = int(opt_g["step"])
    set_lr(state, float(opt_g["lr"]), float(opt_d["lr"]))
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
    """Auto-resume scan: the newest epoch whose COMPLETE file set (net + opt
    for G and D) is present, as this package's `.pth` files or a JAX run's
    `.ckpt` files (`load_checkpoint` takes the `.pth` set where an epoch has
    both). A run killed mid-save leaves a torn epoch that would break every
    later auto-resume, so the scan falls back to the newest complete one."""
    if not os.path.isdir(save_dir):
        return 0
    epochs = set()
    for f in os.listdir(save_dir):
        m = re.match(r"net_epoch_(\d+)_", f)
        if m:
            epochs.add(int(m.group(1)))

    return max((e for e in epochs
                if _complete(save_dir, e, ".pth") or _complete(save_dir, e, ".ckpt")), default=0)
