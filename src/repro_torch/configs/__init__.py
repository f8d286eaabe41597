"""Model configurations of the port: the paper's ResNets (``FULL``,
``SMOKE``) and the ten early-exit LMs served beside them (``get_config``,
``ARCH_IDS`` in the reference's order), and the dry-run's shape table
(``SHAPES``, ``applicable``, ``skip_reason``, ``input_specs``; meta
tensors in place of ``jax.ShapeDtypeStruct``)."""

from __future__ import annotations

from typing import Dict, List

from repro_torch.configs import (
    deepseek_moe_16b,
    deepseek_v3_671b,
    jamba_v0_1_52b,
    llava_next_mistral_7b,
    phi4_mini_3_8b,
    qwen3_8b,
    rwkv6_1_6b,
    seamless_m4t_large_v2,
    smollm_135m,
    starcoder2_7b,
)
from repro_torch.configs.edgeserving_resnets import FULL, SMOKE
from repro_torch.configs.shapes import (
    SHAPES,
    ShapeSpec,
    applicable,
    input_specs,
    skip_reason,
)
from repro_torch.models.transformer import LMConfig

_MODULES = {
    "seamless-m4t-large-v2": seamless_m4t_large_v2,
    "qwen3-8b": qwen3_8b,
    "smollm-135m": smollm_135m,
    "starcoder2-7b": starcoder2_7b,
    "phi4-mini-3.8b": phi4_mini_3_8b,
    "deepseek-moe-16b": deepseek_moe_16b,
    "deepseek-v3-671b": deepseek_v3_671b,
    "llava-next-mistral-7b": llava_next_mistral_7b,
    "rwkv6-1.6b": rwkv6_1_6b,
    "jamba-v0.1-52b": jamba_v0_1_52b,
}

ARCH_IDS: List[str] = list(_MODULES)


def get_config(arch_id: str, smoke: bool = False) -> LMConfig:
    try:
        mod = _MODULES[arch_id]
    except KeyError:
        raise ValueError(
            f"unknown arch {arch_id!r}; available: {ARCH_IDS}") from None
    return mod.SMOKE if smoke else mod.FULL


def all_configs(smoke: bool = False) -> Dict[str, LMConfig]:
    return {a: get_config(a, smoke) for a in ARCH_IDS}


__all__ = ["ARCH_IDS", "FULL", "SHAPES", "SMOKE", "ShapeSpec", "all_configs",
           "applicable", "get_config", "input_specs", "skip_reason"]
