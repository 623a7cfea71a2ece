"""JAX/flax parameters -> the port's `state_dict`s, and back.

The port's modules carry the reference's torch names, so the mappings are
the ones hoig_tpu/models/torch_port.py applies in the other direction (a
copy: the port imports nothing of hoig_tpu). `flax_tree_from_torch` lays
port tensors (a state dict, or gradients by parameter name) out on the flax
tree's paths, so that tests compare leaf by leaf. Layout transforms,
flax -> torch:

  * Conv HWIO -> OIHW: transpose(3, 2, 0, 1);
  * ConvTranspose HWIO (flax correlates the dilated input with an unflipped
    kernel; torch's transposed conv is a flipped-kernel correlation) ->
    IOHW: spatial flip, then transpose(2, 3, 0, 1);
  * InstanceNorm scale / bias -> weight / bias; biases as they are.
"""

from __future__ import annotations

import numpy as np
import torch

_CONV, _CONVT, _DIRECT = "conv", "convt", "direct"

_FULL_ATTN = (1, 2, 3, 4, 5, 6, 7, 8, 9)
GEN_LAYOUTS = {
    # gen_name -> (spade_layers, attn_layers)
    "generator_base": ((0, 0, 0, 0), ()),
    "generator_spade": ((1, 1, 0, 0), ()),
    "generator_spade_attn": ((1, 1, 0, 0), _FULL_ATTN),
    "generator_spade_attn_tiny": ((0, 0, 1, 1), _FULL_ATTN),
}


def _to_torch(kind: str, a: np.ndarray) -> np.ndarray:
    a = np.asarray(a, dtype=np.float32)
    if kind == _CONV:
        return np.ascontiguousarray(a.transpose(3, 2, 0, 1))
    if kind == _CONVT:
        return np.ascontiguousarray(a[::-1, ::-1].transpose(2, 3, 0, 1))
    return a


def _from_torch(kind: str, a: np.ndarray) -> np.ndarray:
    """The inverse of `_to_torch`."""
    a = np.asarray(a, dtype=np.float32)
    if kind == _CONV:
        return np.ascontiguousarray(a.transpose(2, 3, 1, 0))
    if kind == _CONVT:
        return np.ascontiguousarray(a.transpose(2, 3, 0, 1)[::-1, ::-1])
    return a


def _spade(fp: tuple, tp: str):
    out = []
    for head, tname in (("mlp_shared", "mlp_shared.0"), ("mlp_gamma", "mlp_gamma"),
                        ("mlp_beta", "mlp_beta")):
        out.append((fp + (head, "kernel"), f"{tp}.{tname}.weight", _CONV))
        out.append((fp + (head, "bias"), f"{tp}.{tname}.bias", _DIRECT))
    return out


def _conv_in_relu(fp: tuple, t_conv: str, t_in: str, convt: bool = False):
    name, kind = ("ConvTranspose_0", _CONVT) if convt else ("Conv_0", _CONV)
    return [
        (fp + (name, "kernel"), f"{t_conv}.weight", kind),
        (fp + ("InstanceNorm_0", "scale"), f"{t_in}.weight", _DIRECT),
        (fp + ("InstanceNorm_0", "bias"), f"{t_in}.bias", _DIRECT),
    ]


def _residual(fp: tuple, tp: str, learned_shortcut: bool = False):
    """ResidualBlock; with `learned_shortcut` (dim_in != dim_out) also its
    norm_s (InstanceNorm) and conv_s (1x1, no bias)."""
    out = [
        (fp + ("Conv_0", "kernel"), f"{tp}.main.0.weight", _CONV),
        (fp + ("InstanceNorm_0", "scale"), f"{tp}.main.1.weight", _DIRECT),
        (fp + ("InstanceNorm_0", "bias"), f"{tp}.main.1.bias", _DIRECT),
        (fp + ("Conv_1", "kernel"), f"{tp}.main.3.weight", _CONV),
        (fp + ("InstanceNorm_1", "scale"), f"{tp}.main.4.weight", _DIRECT),
        (fp + ("InstanceNorm_1", "bias"), f"{tp}.main.4.bias", _DIRECT),
    ]
    if learned_shortcut:
        out += [
            (fp + ("norm_s", "scale"), f"{tp}.norm_s.weight", _DIRECT),
            (fp + ("norm_s", "bias"), f"{tp}.norm_s.bias", _DIRECT),
            (fp + ("conv_s", "kernel"), f"{tp}.conv_s.weight", _CONV),
        ]
    return out


def _spade_residual(fp: tuple, tp: str, learned_shortcut: bool = False):
    """SPADEResidualBlock; with `learned_shortcut` also its norm_s (SPADE)
    and conv_s (1x1, no bias)."""
    out = []
    for c in ("conv_0", "conv_1"):
        out.append((fp + (c, "kernel"), f"{tp}.{c}.weight", _CONV))
        out.append((fp + (c, "bias"), f"{tp}.{c}.bias", _DIRECT))
    out += _spade(fp + ("norm_0",), f"{tp}.norm_0") + _spade(fp + ("norm_1",), f"{tp}.norm_1")
    if learned_shortcut:
        out += _spade(fp + ("norm_s",), f"{tp}.norm_s")
        out.append((fp + ("conv_s", "kernel"), f"{tp}.conv_s.weight", _CONV))
    return out


def _spade_block(fp: tuple, tp: str, convt: bool = False):
    name, kind = ("ConvTranspose_0", _CONVT) if convt else ("Conv_0", _CONV)
    return [(fp + (name, "kernel"), f"{tp}.conv.weight", kind)] + _spade(fp + ("norm",), f"{tp}.norm")


def _resnet_generator(fp: tuple, tp: str, n_down: int, repeat: int):
    out = _conv_in_relu(fp + ("ConvINReLU_0",), f"{tp}.model.0", f"{tp}.model.1")
    for d in range(n_down):
        base = 3 + 3 * d
        out += _conv_in_relu(fp + (f"ConvINReLU_{d + 1}",), f"{tp}.model.{base}",
                             f"{tp}.model.{base + 1}")
    res0 = 3 + 3 * n_down
    for r in range(repeat):
        out += _residual(fp + (f"ResidualBlock_{r}",), f"{tp}.model.{res0 + r}")
    up0 = res0 + repeat
    for u in range(n_down):
        base = up0 + 3 * u
        out += _conv_in_relu(fp + (f"UpConvINReLU_{u}",), f"{tp}.model.{base}",
                             f"{tp}.model.{base + 1}", convt=True)
    out.append((fp + ("Conv_0", "kernel"), f"{tp}.model.{up0 + 3 * n_down}.weight", _CONV))
    return out


def _resunet_generator(fp: tuple, tp: str, n_down: int, repeat: int, spade_layers, on_obj: bool):
    out = _conv_in_relu(fp + ("encoders_0",), f"{tp}.encoders.0.0", f"{tp}.encoders.0.1")
    for i in range(1, n_down + 1):
        if spade_layers[0]:
            out += _spade_block(fp + (f"encoders_{i}",), f"{tp}.encoders.{i}")
        else:
            out += _conv_in_relu(fp + (f"encoders_{i}",), f"{tp}.encoders.{i}.0",
                                 f"{tp}.encoders.{i}.1")
    for i in range(repeat):
        spade = spade_layers[1] if i < repeat // 2 else spade_layers[2]
        block = _spade_residual if spade else _residual
        out += block(fp + (f"resnets_{i}",), f"{tp}.resnets.{i}")
    for i in range(n_down):
        if spade_layers[3]:
            out += _spade_block(fp + (f"decoders_{i}",), f"{tp}.decoders.{i}", convt=True)
        else:
            out += _conv_in_relu(fp + (f"decoders_{i}",), f"{tp}.decoders.{i}.0",
                                 f"{tp}.decoders.{i}.1", convt=True)
        out += _conv_in_relu(fp + (f"skippers_{i}",), f"{tp}.skippers.{i}.0",
                             f"{tp}.skippers.{i}.1")
    out.append((fp + ("img_reg", "kernel"), f"{tp}.img_reg.0.weight", _CONV))
    if not on_obj:
        out.append((fp + ("attn_reg_hand", "kernel"), f"{tp}.attetion_reg_hand.0.weight", _CONV))
        out.append((fp + ("attn_reg_bg", "kernel"), f"{tp}.attetion_reg_bg.0.weight", _CONV))
    return out


def generator_mapping(gen_name: str, repeat_num: int, n_down: int = 3):
    """(flax path, torch key, transform) for every Generator parameter."""
    spade_layers, attn_layers = GEN_LAYOUTS[gen_name]
    out = _resnet_generator(("bg_model",), "bg_model", n_down, repeat_num)
    for name, on_obj in (("obj_model", True), ("src_model", False), ("tsf_model", False)):
        out += _resunet_generator((name,), name, n_down, repeat_num, spade_layers, on_obj)
    for l in (l for l in attn_layers if l <= n_down + repeat_num):
        p, t = (f"attn_{l}",), f"attn_{l}.fully_connect_layer"
        out += [
            (p + ("fc_0_kernel",), f"{t}.0.weight", _CONV),
            (p + ("fc_0_bias",), f"{t}.0.bias", _DIRECT),
            (p + ("fc_1_kernel",), f"{t}.2.weight", _CONV),
            (p + ("fc_1_bias",), f"{t}.2.bias", _DIRECT),
        ]
    return out


def discriminator_mapping(n_layers: int = 4):
    """PatchDiscriminator with norm_type='instance' (no norm parameters):
    the convs sit at Sequential indices 0, then 2 + 3(n - 1) for the stride-2
    blocks, the stride-1 block, then the 1-channel head."""
    idxs = [0] + [2 + 3 * (n - 1) for n in range(1, n_layers)]
    idxs.append(idxs[-1] + 3)
    idxs.append(idxs[-1] + 3)
    out = []
    for j, ti in enumerate(idxs):
        out.append(((f"Conv_{j}", "kernel"), f"model.{ti}.weight", _CONV))
        out.append(((f"Conv_{j}", "bias"), f"model.{ti}.bias", _DIRECT))
    return out


# torchvision layer index of each of the 13 VGG19 convs on the loss's path
_VGG_TORCH_IDX = (0, 2, 5, 7, 10, 12, 14, 16, 19, 21, 23, 25, 28)


def vgg_mapping():
    out = []
    for ci, ti in enumerate(_VGG_TORCH_IDX):
        out.append(((f"conv_{ci}", "kernel"), f"features.{ti}.weight", _CONV))
        out.append(((f"conv_{ci}", "bias"), f"features.{ti}.bias", _DIRECT))
    return out


def _leaf_paths(tree: dict, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaf_paths(v, prefix + (k,))
        else:
            yield prefix + (k,)


def _state_dict_from_flax(params_np: dict, mapping) -> dict:
    """flax tree (numpy leaves, with or without the 'params' level) ->
    {torch key: tensor}. Raises if a mapped flax leaf is missing or if the
    tree holds a leaf the mapping does not cover."""
    tree = params_np.get("params", params_np)
    state, used = {}, set()
    for path, key, kind in mapping:
        node = tree
        for p in path:
            if p not in node:
                raise KeyError(f"flax tree has no '{'/'.join(path)}' (config mismatch?)")
            node = node[p]
        state[key] = torch.tensor(_to_torch(kind, node))
        used.add(path)
    extra = [p for p in _leaf_paths(tree) if p not in used]
    if extra:
        raise ValueError(f"{len(extra)} flax leaves not covered, e.g. {extra[:3]}")
    return state


def generator_state_dict_from_flax(params_np: dict, tcfg) -> dict:
    """flax Generator tree -> state dict of the port's Generator built from `tcfg`."""
    return _state_dict_from_flax(params_np, generator_mapping(tcfg.gen_name, tcfg.repeat_num))


def discriminator_state_dict_from_flax(params_np: dict, n_layers: int = 4) -> dict:
    """flax PatchDiscriminator tree -> state dict of the port's PatchDiscriminator."""
    return _state_dict_from_flax(params_np, discriminator_mapping(n_layers))


def vgg_state_dict_from_flax(params_np: dict) -> dict:
    """flax Vgg19Features tree -> state dict of the port's Vgg19Features."""
    return _state_dict_from_flax(params_np, vgg_mapping())


def inception_state_dict_from_flax(variables_np: dict) -> dict:
    """flax FIDInceptionV3 variables ({"params", "batch_stats"}, numpy
    leaves) -> state dict of the port's FIDInceptionV3 (pytorch-fid's keys;
    `num_batches_tracked` is not carried). Raises if a leaf is left over."""
    state = {}

    def walk(params: dict, stats: dict, prefix: str):
        for name, node in params.items():
            key = f"{prefix}{name}"
            if name == "conv":
                state[f"{key}.weight"] = torch.tensor(_to_torch(_CONV, node.pop("kernel")))
            elif name == "bn":
                bn_stats = stats[name]
                for src, dst, tree in (("scale", "weight", node), ("bias", "bias", node),
                                       ("mean", "running_mean", bn_stats),
                                       ("var", "running_var", bn_stats)):
                    state[f"{key}.{dst}"] = torch.tensor(np.asarray(tree.pop(src), np.float32))
            else:
                walk(node, stats.get(name, {}), key + ".")

    params = _copy_tree(variables_np["params"])
    stats = _copy_tree(variables_np["batch_stats"])
    walk(params, stats, "")
    left = [p for p in (*_leaf_paths(params), *_leaf_paths(stats))]
    if left:
        raise ValueError(f"{len(left)} flax leaves not covered, e.g. {left[:3]}")
    return state


def lpips_state_dict_from_flax(params_np: dict) -> dict:
    """flax LPIPSNet tree (with or without the 'params' level) -> state dict
    of the port's LPIPSNet: `alexnet.features.{0,3,6,8,10}` (torchvision's
    indices) and `lpips_weights.{i}.main.1.weight`."""
    mapping = []
    for i, ti in enumerate((0, 3, 6, 8, 10)):
        mapping += [(("alexnet", f"conv_{i}", "kernel"), f"alexnet.features.{ti}.weight", _CONV),
                    (("alexnet", f"conv_{i}", "bias"), f"alexnet.features.{ti}.bias", _DIRECT),
                    ((f"lin_{i}", "kernel"), f"lpips_weights.{i}.main.1.weight", _CONV)]
    return _state_dict_from_flax(params_np, mapping)


def _copy_tree(tree: dict) -> dict:
    return {k: _copy_tree(v) if isinstance(v, dict) else v for k, v in tree.items()}


def flax_tree_from_torch(named: dict, mapping) -> dict:
    """{torch key: tensor} (a state dict, or gradients by parameter name) ->
    nested dict of numpy arrays on the flax tree's paths and layouts.
    Raises if `named` lacks a mapped key or holds one the mapping does not cover."""
    tree, used = {}, set()
    for path, key, kind in mapping:
        if key not in named:
            raise KeyError(f"no '{key}' among the given tensors (config mismatch?)")
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = _from_torch(kind, named[key].detach().cpu().numpy())
        used.add(key)
    extra = sorted(set(named) - used)
    if extra:
        raise ValueError(f"{len(extra)} tensors not covered, e.g. {extra[:3]}")
    return tree
