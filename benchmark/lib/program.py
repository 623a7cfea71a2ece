"""The system under test: the port's entry points, built from the port's own
modules for one configuration and loaded with the benchmark's weights.

Training drives `hoig_torch.train.trainer.make_train_step`'s step (the
conditioning, G, the losses, D and the two Adam updates); serving drives
`hoig_torch.train.model_api.flow_only` then `forward_only`. The port builds
its face tables from the benchmark's mesh files with its own code
(`build_surface_tables`). Nothing here is imported before a run asks for it.
"""

from __future__ import annotations

import torch


def train_config(cfg: dict):
    """The port's TrainConfig for a configuration file: its widths and loss
    weights, the precision it states (bf16 with the bf16 remat defaults, as
    `train_config_from_opt` builds them under --bf16) and the corner engine
    `resolve_corner_engine` picks for that precision."""
    from hoig_torch.train.environment import resolve_corner_engine
    from hoig_torch.train.trainer import TrainConfig

    bf16 = cfg["compute_dtype"] == "bfloat16"
    keys = ("gen_name", "repeat_num", "conv_dim", "image_size", "bg_dim", "img_dim", "obj_dim",
            "img_cond_dim", "obj_cond_dim", "d_input_nc", "d_norm_type", "use_armask", "lr_G",
            "lr_D", "adam_b1", "adam_b2", "lambda_D_prob", "lambda_rec", "lambda_tsf",
            "lambda_mask", "lambda_mask_smooth", "use_vgg", "mask_bce", "remat",
            "remat_bottleneck", "remat_attn")
    return TrainConfig(use_spade=True, corner_engine=resolve_corner_engine(cfg["corner_engine"], bf16),
                       compute_dtype=torch.bfloat16 if bf16 else torch.float32,
                       **{k: cfg[k] for k in keys})


def conditioning_config(cfg: dict):
    from hoig_torch.geometry.conditioning import ConditioningConfig

    return ConditioningConfig(image_size=cfg["image_size"], camera_model=cfg["camera_model"],
                              mano_pca_comps=cfg["mano_pca_comps"],
                              mano_flat_hand_mean=cfg["mano_flat_hand_mean"])


class Program:
    """One configuration of the port on `device`: tables and MANO built by
    the port, networks built by the port and loaded with `weights`
    ({"g", "d", "vgg"}: {name: tensor}). `kind` "train" builds the training
    state and step, "serve" the generator alone."""

    def __init__(self, cfg: dict, assets, weights: dict, kind: str, device):
        from hoig_torch.geometry.mano import MANOModel
        from hoig_torch.geometry.renderer import ObjectSpec, build_surface_tables
        from hoig_torch.models.vgg import init_vgg
        from hoig_torch.ops import _cuda
        from hoig_torch.train.trainer import (build_generator, build_networks, init_state,
                                              make_train_step)

        self.device = torch.device(device)
        if self.device.type == "cuda":
            _cuda.build_all()
        self.tcfg, self.ccfg = train_config(cfg), conditioning_config(cfg)
        specs = [ObjectSpec(name=f"{i:03d}_synthetic", obj_path=p)
                 for i, p in enumerate(assets.object_paths)]
        tables_np = build_surface_tables(assets.hand_uv_path, specs, assets.sem,
                                         image_size=cfg["image_size"])
        self.frozen = dict(tables=tables_np.as_torch(self.device),
                           mano_params=MANOModel(**assets.mano).as_torch(self.device))
        self.kind = kind
        if kind == "train":
            g, d = build_networks(self.tcfg, device=self.device)
            vgg = init_vgg(compute_dtype=self.tcfg.compute_dtype, device=self.device)
            for net, name in ((g, "g"), (d, "d"), (vgg, "vgg")):
                _load(net, weights[name])
            self.state = init_state(g, d, self.tcfg)
            self._step = make_train_step(vgg, self.frozen["tables"], self.frozen["mano_params"],
                                         self.ccfg, self.tcfg)
        else:
            self.g = build_generator(self.tcfg, device=self.device)
            _load(self.g, weights["g"])

    # ------------------------------------------------------------ training

    def step(self, batch: dict) -> dict:
        """One training step with D trained; the metrics as device scalars."""
        self.state, metrics = self._step(self.state, batch, True)
        return metrics

    def named_params(self) -> dict:
        """{"g.<key>" / "d.<key>": parameter}."""
        out = {f"g.{k}": p for k, p in self.state.g.named_parameters()}
        out.update({f"d.{k}": p for k, p in self.state.d.named_parameters()})
        return out

    def watch_generator(self) -> tuple:
        """Record the next generator call of the training step: returns
        (record, remove); record gets "inputs" (its twelve NHWC inputs in
        call order, None where absent) and "outputs" (its ten raw outputs)."""
        order = ("bg_inputs", "src_obj_inputs", "tsf_obj_inputs", "src_hand_inputs",
                 "tsf_hand_inputs", "T", "src_obj_conds", "src_hand_conds", "tsf_obj_conds",
                 "tsf_hand_conds", "src_armask", "tsf_armask")
        record: dict = {}

        def hook(module, args, kwargs, outs):
            if not record:
                record["inputs"] = tuple(
                    None if kwargs.get(k) is None else kwargs[k].detach().clone() for k in order)
                record["outputs"] = tuple(o.detach().clone() for o in outs)
        handle = self.state.g.register_forward_hook(hook, with_kwargs=True)
        return record, handle.remove

    def first_grad_norms(self) -> dict:
        """The first step's gradient of each parameter as Adam got it, from
        its state after one step: exp_avg = (1 - beta1) g."""
        out = {}
        for prefix, net, opt in (("g", self.state.g, self.state.opt_g),
                                 ("d", self.state.d, self.state.opt_d)):
            b1 = opt.param_groups[0]["betas"][0]
            for k, p in net.named_parameters():
                st = opt.state.get(p)
                out[f"{prefix}.{k}"] = (st["exp_avg"].float() / (1.0 - b1)).norm() if st else None
        return out

    # ------------------------------------------------------------- serving

    def serve(self, batch: dict) -> tuple:
        """(conditioning, composite outputs) of one serving call."""
        flow = self.conditioning(batch)
        return flow, self.generator(flow, batch)

    def conditioning(self, batch: dict) -> dict:
        """`flow_only`: the conditioning of one serving call."""
        from hoig_torch.train.model_api import flow_only

        return flow_only(batch, self.frozen, self.ccfg)

    def generator(self, flow: dict, batch: dict) -> tuple:
        """`forward_only`: the generator and the composite of one call."""
        from hoig_torch.train.model_api import forward_only

        return forward_only(self.g, flow, batch, self.tcfg)


@torch.no_grad()
def _load(net: torch.nn.Module, weights: dict) -> None:
    """Copy the benchmark's weights into the port's parameters (same keys,
    same shapes; the port keeps its own memory layout)."""
    own = dict(net.named_parameters())
    if set(own) != set(weights):
        missing, extra = sorted(set(own) - set(weights)), sorted(set(weights) - set(own))
        raise KeyError(f"weights do not fit the port's network: missing {missing[:3]}, "
                       f"unknown {extra[:3]}")
    for k, p in own.items():
        if tuple(p.shape) != tuple(weights[k].shape):
            raise ValueError(f"{k}: the port's shape {tuple(p.shape)}, the weights' "
                             f"{tuple(weights[k].shape)}")
        p.copy_(weights[k])
