"""Model configurations of the port: the paper's ResNets (``FULL``,
``SMOKE``) and the dense early-exit LMs served beside them
(``get_config``)."""

from __future__ import annotations

from typing import List

from repro_torch.configs import phi4_mini_3_8b, qwen3_8b, smollm_135m
from repro_torch.configs.edgeserving_resnets import FULL, SMOKE
from repro_torch.models.transformer import LMConfig

_MODULES = {
    "smollm-135m": smollm_135m,
    "phi4-mini-3.8b": phi4_mini_3_8b,
    "qwen3-8b": qwen3_8b,
}

ARCH_IDS: List[str] = list(_MODULES)


def get_config(arch_id: str, smoke: bool = False) -> LMConfig:
    try:
        mod = _MODULES[arch_id]
    except KeyError:
        raise ValueError(
            f"unknown arch {arch_id!r}; ported: {ARCH_IDS}") from None
    return mod.SMOKE if smoke else mod.FULL


__all__ = ["ARCH_IDS", "FULL", "SMOKE", "get_config"]
