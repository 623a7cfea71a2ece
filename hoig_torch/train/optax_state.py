"""optax Adam state <-> torch.optim.Adam state, through the parameter maps.

The JAX package saves each optimizer as `{"opt": {"0": {"count", "mu",
"nu"}, "1": {}}, "lr", "step"}` (hoig_tpu/train/checkpoints.py:56-66): optax's
ScaleByAdamState and the empty state of its learning-rate scale, with mu and
nu laid out as the flax parameter tree. torch's Adam keeps, per parameter,
`exp_avg` (mu), `exp_avg_sq` (nu) and `step` (count), keyed by the
parameter's position in the optimizer. The moments go through the same
layout maps as the weights (`hoig_torch.models.convert`: HWIO -> OIHW, the
transposed convolutions flipped), which are linear, so a map of the moments
is the moment of the mapped gradients.

Both optimizers compute the same update: optax's
mu_hat / (sqrt(nu_hat) + eps) times the learning rate, torch's
exp_avg / (sqrt(exp_avg_sq) / sqrt(1 - b2^t) + eps) * lr / (1 - b1^t); they
apply the bias corrections in another order, so they agree to rounding.

D's count counts the steps that trained D: the JAX step masks D's Adam
state on a gated step (hoig_tpu/train/trainer.py:336-347), and the port's
step skips `opt_d.step()`.
"""

from __future__ import annotations

import numpy as np
import torch

from hoig_torch.models.convert import _state_dict_from_flax, flax_tree_from_torch


def _trainable(module: torch.nn.Module) -> list:
    """(name, parameter) in the order `trainer._adam` hands them to Adam."""
    return [(n, p) for n, p in module.named_parameters() if p.requires_grad]


def _check_order(optimizer: torch.optim.Optimizer, named: list) -> None:
    params = [p for g in optimizer.param_groups for p in g["params"]]
    if len(params) != len(named) or any(a is not b for a, (_, b) in zip(params, named)):
        raise ValueError("the optimizer does not hold the module's trainable parameters in "
                         "module order")


def adam_state_dict_from_optax(opt_tree: dict, optimizer: torch.optim.Optimizer,
                               module: torch.nn.Module, mapping) -> dict:
    """optax's `{"0": {"count", "mu", "nu"}, "1": {}}` (numpy leaves) -> a
    state dict that `optimizer.load_state_dict` takes, for the optimizer of
    `module`'s trainable parameters; `mapping` is the module's
    (flax path, torch key, layout) list. Adam's `step` is a float32 CPU
    scalar, where torch's own Adam keeps it (load_state_dict moves it only
    for a capturable or fused Adam)."""
    adam = opt_tree["0"]
    count = int(np.asarray(adam["count"]))
    mu = _state_dict_from_flax(adam["mu"], mapping)
    nu = _state_dict_from_flax(adam["nu"], mapping)
    named = _trainable(module)
    _check_order(optimizer, named)
    if set(mu) != {n for n, _ in named}:
        raise ValueError("the optax moments and the module's parameters do not match")
    state = {}
    if count > 0:  # a fresh torch Adam holds no state until its first step
        for i, (n, _) in enumerate(named):
            state[i] = {"step": torch.tensor(float(count), dtype=torch.float32),
                        "exp_avg": mu[n], "exp_avg_sq": nu[n]}
    groups = optimizer.state_dict()["param_groups"]
    return {"state": state, "param_groups": groups}


def optax_from_adam(optimizer: torch.optim.Optimizer, module: torch.nn.Module, mapping) -> dict:
    """The inverse: torch Adam's state -> optax's `{"0": {"count", "mu",
    "nu"}, "1": {}}` with numpy leaves on the flax parameter tree
    (`{"params": ...}`), zeros where Adam has not stepped yet."""
    named = _trainable(module)
    _check_order(optimizer, named)
    steps = {float(optimizer.state[p]["step"]) for _, p in named if p in optimizer.state}
    if len(steps) > 1:
        raise ValueError(f"the parameters' Adam steps differ: {sorted(steps)}")
    count = int(steps.pop()) if steps else 0

    def moment(key):
        return flax_tree_from_torch(
            {n: optimizer.state[p][key] if p in optimizer.state else torch.zeros_like(p)
             for n, p in named}, mapping)

    return {"0": {"count": np.int32(count), "mu": {"params": moment("exp_avg")},
                  "nu": {"params": moment("exp_avg_sq")}}, "1": {}}
