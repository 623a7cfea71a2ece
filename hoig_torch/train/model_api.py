"""Entry points of the model: the serving functions and the Trainer-API facade
(port of hoig_tpu/train/model_api.py).

`flow_only` and `forward_only` are the serving path (conditioning, then
generator forward and composite). `HOIGModel` gives the drivers the
reference's Trainer surface (models/trainer.py:188-595): set_input /
forward / optimize_parameters / save / load / update_learning_rate /
get_current_{errors,visuals,scalars} / set_train / set_eval, over
`make_train_step`, `make_eval_metrics`, `decay_lr` and the checkpoints.
One process drives one device: nothing is sharded or padded, and a partial
batch runs as it is. Under torchrun each process is one rank of the data-
parallel run (hoig_torch.parallel): the facade's step then averages the
gradients and metrics over the ranks.
"""

from __future__ import annotations

import os
from collections import OrderedDict

import torch

from hoig_torch.geometry.conditioning import ConditioningConfig, hand_recovery_flow
from hoig_torch.models.vgg import init_vgg
from hoig_torch.ops._cuda import resolve_device
from hoig_torch.parallel import DataParallel, is_distributed
from hoig_torch.train import checkpoints as ckpt
from hoig_torch.train.environment import build_environment, train_config_from_opt
from hoig_torch.train.trainer import (
    TrainConfig,
    build_networks,
    composite,
    decay_lr,
    generator_kwargs,
    init_state,
    make_eval_metrics,
    make_train_step,
)
from hoig_torch.utils.util import tensor2im, tensor2maskim

# the reference's setup_seed(8) (train.py:153); G, D and VGG draw from
# SEED, SEED + 1 and SEED + 2
SEED = 8
# the batch entries the model reads (names and paths stay on the host)
_BATCH_KEYS = ("imageA", "imageB", "maskA", "maskB", "manoA", "manoB")
_ERROR_KEYS = ("g_rec", "g_tsf", "g_adv", "g_mask", "g_mask_smooth", "d_real", "d_fake")


def batch_as_torch(batch: dict, device) -> dict:
    """A numpy batch (synthetic_batch layout) as tensors on `device`."""
    conv = lambda v: torch.as_tensor(v, device=device)
    return {k: ({kk: conv(vv) for kk, vv in v.items()} if isinstance(v, dict) else conv(v))
            for k, v in batch.items()}


@torch.inference_mode()
def flow_only(batch: dict, frozen: dict, ccfg: ConditioningConfig) -> dict:
    """Conditioning for one batch; frozen = dict(tables, mano_params)."""
    return hand_recovery_flow(frozen["tables"], frozen["mano_params"], batch["imageA"],
                              batch["imageB"], batch["manoA"], batch["manoB"], ccfg)


@torch.inference_mode()
def forward_only(model: torch.nn.Module, flow: dict, batch: dict, tcfg: TrainConfig):
    """Generator forward + composite: (fake_src, fake_tsf, masks...), NHWC."""
    kwargs = generator_kwargs(
        flow,
        batch.get("maskA") if tcfg.use_armask else None,
        batch.get("maskB") if tcfg.use_armask else None,
        tcfg.use_spade,
    )
    return composite(model(**kwargs))


class ModelsFactory:
    @staticmethod
    def get_by_name(model_name: str, opt, env=None):
        if model_name == "trainer":
            return HOIGModel(opt, env=env)
        raise ValueError(f"Model {model_name} not recognized.")


def load_vgg_weights(vgg: torch.nn.Module, path: str) -> None:
    """Load a torchvision vgg19 state dict (.pth) or its .npz dump into
    Vgg19Features by key (`features.N.weight` / `.bias`); the keys past
    the 13th convolution (and the classifier) are not used."""
    state = ckpt.load_state_dict_file(path)
    own = vgg.state_dict()
    missing = [k for k in own if k not in state]
    if missing:
        raise KeyError(f"{path} lacks {len(missing)} VGG19 keys, e.g. {missing[:3]}")
    vgg.load_state_dict({k: state[k] for k in own})


class HOIGModel:
    """The GAN trainer with the reference's method surface, on `opt.device`."""

    def __init__(self, opt, env=None):
        self._opt = opt
        self._name = "Trainer"
        self._is_train = getattr(opt, "is_train", False)
        self._save_dir = os.path.join(opt.checkpoints_dir, opt.name)
        self._device = resolve_device(getattr(opt, "device", "cuda"))

        self._env = env or build_environment(opt, self._device)
        self._tcfg = train_config_from_opt(opt)
        self._ccfg = self._env["ccfg"]
        self._frozen = dict(tables=self._env["tables"], mano_params=self._env["mano_params"])

        g, d = build_networks(self._tcfg, device=self._device, seed=SEED)
        self._vgg = init_vgg(seed=SEED + 2, compute_dtype=self._tcfg.compute_dtype,
                             device=self._device)
        vgg_path = getattr(opt, "vgg_weights", None)
        synthetic = getattr(opt, "synthetic_data", False) or opt.dataset_mode == "synthetic"
        if vgg_path and os.path.exists(vgg_path):
            load_vgg_weights(self._vgg, vgg_path)
            print(f"loaded vgg19 weights from {vgg_path}")
        elif self._tcfg.use_vgg and self._is_train and not synthetic:
            # training a real dataset against random VGG features silently
            # departs from the reference objective: refuse (a synthetic
            # smoke run may proceed with the seeded random weights)
            raise RuntimeError(
                "--use_vgg training requires pretrained VGG19 features: --vgg_weights "
                f"{vgg_path or '<path>'} " + ("not found" if vgg_path else "not given")
                + ". Pass torchvision's vgg19 state dict (.pth) or its .npz dump "
                "(or --dataset_mode synthetic for a smoke run)")
        elif vgg_path:
            print(f"[warn] --vgg_weights {vgg_path} not found: random-feature perceptual loss")
        elif self._tcfg.use_vgg:
            print("[warn] --use_vgg without --vgg_weights: random-feature perceptual loss "
                  "(seeded weights)")

        self._state = init_state(g, d, self._tcfg)
        self._eval_fn = make_eval_metrics(self._vgg, self._tcfg)

        # load networks (reference __init__ tail, trainer.py:206-210)
        if getattr(opt, "load_path", None) not in (None, "None"):
            ckpt.load_generator_params(self._state.g, opt.load_path, self._tcfg)
        elif getattr(opt, "load_epoch", 0) > 0:
            self.load()
        # under torchrun, rank 0's weights go to every rank (after the load)
        # and the step averages the gradients over the ranks
        self._dp = DataParallel(self._state) if self._is_train and is_distributed() else None
        self._train_step = make_train_step(self._vgg, self._frozen["tables"],
                                           self._frozen["mano_params"], self._ccfg, self._tcfg,
                                           sync=self._dp)

        self._errors = {}
        self._visuals = OrderedDict()
        self._batch = None
        self._flow = None

    # ------------------------------------------------------------- reference API
    @property
    def is_train(self):
        return self._is_train

    def set_train(self):
        self._is_train = True

    def set_eval(self):
        self._is_train = False

    def set_input(self, batch: dict):
        """Move a loader batch (numpy) to the device."""
        self._batch = batch_as_torch(
            {k: ({kk: vv for kk, vv in v.items() if not isinstance(vv, list)}
                 if isinstance(v, dict) else v)
             for k, v in batch.items() if k in _BATCH_KEYS}, self._device)
        self._flow = None

    def forward(self, keep_data_for_visuals: bool = False, compute_losses: bool = True):
        """Generation without a parameter update: (fake_src, fake_tsf,
        src_mask_bg, src_mask_hand, tsf_mask_bg, tsf_mask_hand), NHWC.

        With compute_losses, the eval losses of the training objective are
        computed too (get_current_errors then reads them; the reference's
        forward computes none and its validation logs stale train errors,
        trainer.py:373-415); without, this is flow_only + forward_only."""
        self._flow = flow_only(self._batch, self._frozen, self._ccfg)
        if compute_losses:
            fakes, self._errors = self._eval_fn(self._state.g, self._state.d, self._flow,
                                                self._batch)
        else:
            fakes = forward_only(self._state.g, self._flow, self._batch, self._tcfg)
        if keep_data_for_visuals:
            fake_src, fake_tsf, _, _, tsf_mbg, tsf_mh = fakes
            self._keep_visuals(fake_src, fake_tsf, tsf_mbg, tsf_mh)
        return fakes

    def optimize_parameters(self, trainable: bool = True, keep_data_for_visuals: bool = False):
        """One training step; D is updated where `trainable` says so."""
        if not self._is_train:
            return
        self._state, self._errors = self._train_step(self._state, self._batch, bool(trainable))
        if keep_data_for_visuals:
            # without losses: _errors keeps the step's (a forward with losses
            # would recompute them from the updated parameters)
            self.forward(keep_data_for_visuals=True, compute_losses=False)

    def get_current_errors(self) -> OrderedDict:
        """The losses of the last step or forward as host floats: one
        device sync for all of them."""
        vals = [self._errors.get(k) for k in _ERROR_KEYS]
        dev = [v.detach().float().reshape(()) for v in vals if v is not None]
        host = iter(torch.stack(dev).tolist() if dev else [])
        return OrderedDict((k, 0.0 if v is None else next(host)) for k, v in zip(_ERROR_KEYS, vals))

    def get_current_scalars(self) -> OrderedDict:
        return OrderedDict([("lr_G", float(self._state.lr_g)), ("lr_D", float(self._state.lr_d))])

    def get_current_visuals(self) -> OrderedDict:
        return OrderedDict(self._visuals)

    def save(self, label):
        ckpt.save_checkpoint(self._save_dir, label, self._state)

    def load(self):
        ckpt.load_checkpoint(self._save_dir, self._opt.load_epoch, self._state,
                             load_optimizers=self._is_train, tcfg=self._tcfg)

    def update_learning_rate(self):
        old = self._state.lr_g
        decay_lr(self._state, self._tcfg)
        print(f"update G learning rate: {old:f} -> {self._state.lr_g:f}")
        print(f"update D learning rate: {old:f} -> {self._state.lr_d:f}")

    # ------------------------------------------------------------------ helpers
    def _keep_visuals(self, fake_src, fake_tsf, tsf_mbg, tsf_mh):
        host = lambda x: x.detach().float().cpu().numpy()
        nchw = lambda x: host(x.permute(0, 3, 1, 2))
        batch, flow = self._batch, self._flow
        real_a, real_b, fake_tsf = host(batch["imageA"]), host(batch["imageB"]), nchw(fake_tsf)
        vis = OrderedDict()
        vis["1_real_img"] = tensor2im(real_a)
        for key in ("src_obj", "src_hand", "tsf_obj", "tsf_hand"):
            vis[f"2_input_{key}"] = tensor2im(host(flow[f"input_G_{key}"][:, :3]))
        vis["10_fake_tsf"] = tensor2im(fake_tsf)
        vis["11_fake_src"] = tensor2im(nchw(fake_src))
        vis["12_fake_mask_bg"] = tensor2maskim(nchw(tsf_mbg))
        vis["13_fake_mask_hand"] = tensor2maskim(nchw(tsf_mh))
        vis["14_batch_real_img"] = tensor2im(real_b, idx=-1)
        vis["15_batch_fake_img"] = tensor2im(fake_tsf, idx=-1)
        vis["16_batch_src_img"] = tensor2im(real_a, idx=-1)
        self._visuals = vis
