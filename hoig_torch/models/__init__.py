"""Network registry: the generator names of hoig_tpu's NetworksFactory."""

from __future__ import annotations

import torch

from hoig_torch.models.convert import GEN_LAYOUTS
from hoig_torch.models.generator import ExtractorAttn, Generator, ResNetGenerator, ResUnetGenerator
from hoig_torch.models.layers import init_weights
from hoig_torch.ops._cuda import resolve_device

__all__ = ["ExtractorAttn", "Generator", "NetworksFactory", "ResNetGenerator",
           "ResUnetGenerator"]


class NetworksFactory:
    """Name -> network, built with seeded random weights on `device`."""

    @staticmethod
    def get_by_name(network_name: str, *args, device="cuda", seed: int = 0, **kwargs):
        """A generator in eval mode, weights drawn from `seed`, parameters in
        channels_last memory on `device` (CUDA unless the caller names the
        CPU; raises where CUDA is absent)."""
        dev = resolve_device(device)
        if network_name not in GEN_LAYOUTS:
            raise ValueError(f"Network {network_name} not recognized.")
        spade_layers, attn_layers = GEN_LAYOUTS[network_name]
        net = Generator(*args, **kwargs, spade_layers=spade_layers, attn_layers=attn_layers)
        init_weights(net, seed)
        return net.to(device=dev, memory_format=torch.channels_last).eval()
