"""Model zoo of the port: the paper's early-exit ResNets and the early-exit
LMs of every family of the reference.

``build_model(cfg)`` gives an LMConfig's model: ``DecoderLM`` for the dense
and MoE families (MLA where the config asks for it), ``RWKV6LM``,
``JambaLM`` and ``EncDecLM``. Every LM has ``forward_exit``, ``prefill``,
``exit_decision`` (the served quantum), ``decode_step`` and ``init_cache``.
"""

from typing import Optional

import torch

from repro_torch.device import DeviceLike
from repro_torch.models.convert import (
    lm_cache_from_jax,
    lm_params_from_jax,
    resnet_params_from_jax,
)
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.jamba_model import JambaLM
from repro_torch.models.resnet import EarlyExitResNet, ResNetConfig
from repro_torch.models.rwkv_model import RWKV6LM
from repro_torch.models.transformer import DecoderLM, EarlyExitLM, LMConfig

_FAMILIES = {
    "dense": DecoderLM,
    "moe": DecoderLM,
    "rwkv": RWKV6LM,
    "jamba": JambaLM,
    "encdec": EncDecLM,
}


def build_model(cfg: LMConfig, generator: Optional[torch.Generator] = None,
                device: DeviceLike = None) -> EarlyExitLM:
    """The LM of ``cfg`` with weights from ``generator`` on ``device`` (the
    card unless the caller passes ``"cpu"``)."""
    try:
        family = _FAMILIES[cfg.family]
    except KeyError:
        raise ValueError(f"unknown family {cfg.family!r}; known: "
                         f"{sorted(_FAMILIES)}") from None
    return family(cfg, generator=generator, device=device)


__all__ = ["DecoderLM", "EarlyExitLM", "EarlyExitResNet", "EncDecLM",
           "JambaLM", "LMConfig", "RWKV6LM", "ResNetConfig", "build_model",
           "lm_cache_from_jax", "lm_params_from_jax",
           "resnet_params_from_jax"]
