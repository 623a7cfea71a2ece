"""Network registry: the names of hoig_tpu's NetworksFactory."""

from __future__ import annotations

import torch

from hoig_torch.models.convert import GEN_LAYOUTS
from hoig_torch.models.discriminator import MultiScaleDiscriminator, PatchDiscriminator
from hoig_torch.models.generator import ExtractorAttn, Generator, ResNetGenerator, ResUnetGenerator
from hoig_torch.models.layers import init_weights
from hoig_torch.models.vgg import Vgg19Features, init_vgg, vgg_perceptual_loss
from hoig_torch.ops._cuda import resolve_device

__all__ = ["ExtractorAttn", "Generator", "MultiScaleDiscriminator", "NetworksFactory",
           "PatchDiscriminator", "ResNetGenerator", "ResUnetGenerator", "Vgg19Features",
           "init_vgg", "vgg_perceptual_loss"]


class NetworksFactory:
    """Name -> network, built with seeded random weights on `device`."""

    @staticmethod
    def get_by_name(network_name: str, *args, device="cuda", seed: int = 0, **kwargs):
        """A network with weights drawn from `seed` and parameters in
        channels_last memory on `device` (CUDA unless the caller names the
        CPU; raises where CUDA is absent). Generators come in eval mode
        (they hold no layer that depends on the mode); the discriminator
        comes in train mode, which its BatchNorm variant needs to train."""
        dev = resolve_device(device)
        if network_name in GEN_LAYOUTS:
            spade_layers, attn_layers = GEN_LAYOUTS[network_name]
            net = Generator(*args, **kwargs, spade_layers=spade_layers,
                            attn_layers=attn_layers).eval()
        elif network_name == "discriminator_patch_gan":
            net = PatchDiscriminator(*args, **kwargs).train()
        else:
            raise ValueError(f"Network {network_name} not recognized.")
        init_weights(net, seed)
        return net.to(device=dev, memory_format=torch.channels_last)
