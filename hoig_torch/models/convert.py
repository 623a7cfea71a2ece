"""JAX/flax Generator parameters -> the port's `state_dict`.

The port's modules carry the reference's torch names, so the mapping is the
one hoig_tpu/models/torch_port.py applies in the other direction (a copy:
the port imports nothing of hoig_tpu). Layout transforms, flax -> torch:

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


def _residual(fp: tuple, tp: str):
    return [
        (fp + ("Conv_0", "kernel"), f"{tp}.main.0.weight", _CONV),
        (fp + ("InstanceNorm_0", "scale"), f"{tp}.main.1.weight", _DIRECT),
        (fp + ("InstanceNorm_0", "bias"), f"{tp}.main.1.bias", _DIRECT),
        (fp + ("Conv_1", "kernel"), f"{tp}.main.3.weight", _CONV),
        (fp + ("InstanceNorm_1", "scale"), f"{tp}.main.4.weight", _DIRECT),
        (fp + ("InstanceNorm_1", "bias"), f"{tp}.main.4.bias", _DIRECT),
    ]


def _spade_residual(fp: tuple, tp: str):
    out = []
    for c in ("conv_0", "conv_1"):
        out.append((fp + (c, "kernel"), f"{tp}.{c}.weight", _CONV))
        out.append((fp + (c, "bias"), f"{tp}.{c}.bias", _DIRECT))
    return out + _spade(fp + ("norm_0",), f"{tp}.norm_0") + _spade(fp + ("norm_1",), f"{tp}.norm_1")


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


def generator_state_dict_from_flax(params_np: dict, tcfg) -> dict:
    """flax Generator tree (numpy leaves, with or without the 'params' level)
    -> {torch key: tensor} for the port's Generator built from `tcfg`.

    Raises if a mapped flax leaf is missing or if the tree holds a leaf the
    mapping does not cover."""
    tree = params_np.get("params", params_np)
    mapping = generator_mapping(tcfg.gen_name, tcfg.repeat_num)
    state, used = {}, set()
    for path, key, kind in mapping:
        node = tree
        for p in path:
            if p not in node:
                raise KeyError(f"flax tree has no '{'/'.join(path)}' (config mismatch?)")
            node = node[p]
        state[key] = torch.tensor(_to_torch(kind, node))
        used.add(path)

    def leaves(t, prefix=()):
        for k, v in t.items():
            if isinstance(v, dict):
                yield from leaves(v, prefix + (k,))
            else:
                yield prefix + (k,)

    extra = [p for p in leaves(tree) if p not in used]
    if extra:
        raise ValueError(f"{len(extra)} flax leaves not covered, e.g. {extra[:3]}")
    return state
