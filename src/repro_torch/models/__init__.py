"""Model zoo of the port: the paper's early-exit ResNets and the dense
early-exit decoder LMs.

``build_model(cfg)`` gives an LMConfig's model; this slice carries the dense
family (``DecoderLM``) and raises for the others.
"""

from typing import Optional

import torch

from repro_torch.device import DeviceLike
from repro_torch.models.convert import (
    lm_cache_from_jax,
    lm_params_from_jax,
    resnet_params_from_jax,
)
from repro_torch.models.resnet import EarlyExitResNet, ResNetConfig
from repro_torch.models.transformer import DecoderLM, LMConfig

_FAMILIES = {"dense": DecoderLM}


def build_model(cfg: LMConfig, generator: Optional[torch.Generator] = None,
                device: DeviceLike = None):
    """The LM of ``cfg`` with weights from ``generator`` on ``device`` (the
    card unless the caller passes ``"cpu"``)."""
    try:
        family = _FAMILIES[cfg.family]
    except KeyError:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet; ported: "
            f"{sorted(_FAMILIES)}") from None
    return family(cfg, generator=generator, device=device)


__all__ = ["DecoderLM", "EarlyExitResNet", "LMConfig", "ResNetConfig",
           "build_model", "lm_cache_from_jax", "lm_params_from_jax",
           "resnet_params_from_jax"]
