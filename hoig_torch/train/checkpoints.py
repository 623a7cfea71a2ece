"""Checkpoint save / load with the reference's directory naming contract
(port of hoig_tpu/train/checkpoints.py).

Files are `net_epoch_{E}_id_{G|D}.pth` and `opt_epoch_{E}_id_{G|D}.pth`
under checkpoints_dir/name, so the reference's auto-resume scan
(`startswith("net_epoch_")`, epoch = int(name.split('_')[2])) keeps
working. The payload is `torch.save` of state dicts, read back with
`weights_only=True`; a generator also loads from an `.npz` dump.
"""

from __future__ import annotations

import os
import re

import torch


def _path(save_dir: str, kind: str, epoch, label: str) -> str:
    return os.path.join(save_dir, f"{kind}_epoch_{epoch}_id_{label}.pth")


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


def load_checkpoint(save_dir: str, epoch, state, load_optimizers: bool = True):
    """Restore, in place, a TrainState saved by `save_checkpoint`; G only
    unless `load_optimizers`."""
    from hoig_torch.train.trainer import set_lr

    device = next(state.g.parameters()).device
    state.g.load_state_dict(_strip_module_prefix(_load(_path(save_dir, "net", epoch, "G"), device)))
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


def load_generator_params(g_model: torch.nn.Module, load_path: str) -> torch.nn.Module:
    """Eval-style G-only restore from a generator state dict: this package's
    `net_epoch_*_id_G.pth`, the reference's (whose keys are the same), or
    an `.npz` dump of either."""
    device = next(g_model.parameters()).device
    g_model.load_state_dict(_strip_module_prefix(load_state_dict_file(load_path, device)))
    return g_model


def scan_latest_epoch(save_dir: str) -> int:
    """Auto-resume scan. Only epochs whose COMPLETE file set (net + opt for
    G and D) is present count: a run killed mid-save leaves a torn epoch
    that would break every later auto-resume, so the scan falls back to the
    newest complete epoch."""
    if not os.path.isdir(save_dir):
        return 0
    epochs = set()
    for f in os.listdir(save_dir):
        m = re.match(r"net_epoch_(\d+)_", f)
        if m:
            epochs.add(int(m.group(1)))
    complete = [e for e in epochs
                if all(os.path.exists(_path(save_dir, kind, e, net))
                       for kind in ("net", "opt") for net in ("G", "D"))]
    return max(complete, default=0)
