"""Serving-path entry points (hoig_tpu/train/model_api.py: _flow_only and
_forward_only): conditioning, then generator forward and composite."""

from __future__ import annotations

import torch

from hoig_torch.geometry.conditioning import ConditioningConfig, hand_recovery_flow
from hoig_torch.train.trainer import TrainConfig, composite, generator_kwargs


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
