"""Attention (reference ``src/repro/models/attention.py``): GQA with
optional per-head QK-norm, without a cache (training and prefill).

Shapes: activations are ``[B, S, D]``; query heads ``H``, kv heads ``K``
(GQA groups ``G = H // K``), head dim ``Dh``. The prefill hands back the
per-layer cache ``{"k": [B, S, K, Dh], "v": [B, S, K, Dh], "len": [B]}``.

The attention itself goes through the flash-attention kernel's wrapper
(the plain version on a CPU tensor, the CUDA kernel on a card tensor), with
``[B, H, S, Dh]`` views of the ``[B, S, H, Dh]`` activations: no copies.
``_sdpa`` is the plain path, the reference's jnp attention.

Decode with a KV cache (the cache branch) and MLA wait for the next slices.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import sdpa_plain as _sdpa
from repro_torch.models.common import (
    make_param,
    prefix_rotation,
    rms_norm,
    rotate,
)

__all__ = ["AttentionConfig", "init_attention", "attention", "_sdpa"]


@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    qk_norm: bool = False          # qwen3-style per-head RMS norm on q and k
    causal: bool = True


def init_attention(generator: torch.Generator, cfg: AttentionConfig,
                   dtype: torch.dtype = torch.float32
                   ) -> Dict[str, torch.nn.Parameter]:
    d, h, k_h, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    params = {
        "wq": make_param((d, h * dh), generator, dtype=dtype),
        "wk": make_param((d, k_h * dh), generator, dtype=dtype),
        "wv": make_param((d, k_h * dh), generator, dtype=dtype),
        "wo": make_param((h * dh, d), generator, dtype=dtype),
    }
    if cfg.qk_norm:
        params["q_norm"] = make_param((dh,), generator, init="ones",
                                      dtype=dtype)
        params["k_norm"] = make_param((dh,), generator, init="ones",
                                      dtype=dtype)
    return params


def attention(params, x: torch.Tensor, cfg: AttentionConfig,
              cache: Optional[dict] = None, position=None
              ) -> Tuple[torch.Tensor, Optional[dict]]:
    """Self-attention forward over the whole of ``x`` (causal when
    ``cfg.causal``). When ``position`` is given (prefill), the fresh cache
    ``{"k", "v", "len"}`` is handed back; otherwise the cache is None."""
    if cache is not None:
        raise NotImplementedError(
            "decode with a KV cache (the cache branch of the reference's "
            "attention) is the next slice of the port")
    b, s, _ = x.shape
    h, kh, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ params["wq"]).reshape(b, s, h, dh)
    k = (x @ params["wk"]).reshape(b, s, kh, dh)
    v = (x @ params["wv"]).reshape(b, s, kh, dh)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"])
        k = rms_norm(k, params["k_norm"])
    rotation = prefix_rotation(s, dh, cfg.rope_theta, x.device)
    q = rotate(q, rotation)
    k = rotate(k, rotation)
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=cfg.causal).transpose(1, 2)
    new_cache = None
    if position is not None:  # prefill: hand the KV back for decode
        new_cache = {"k": k, "v": v,
                     "len": torch.full((b,), s, dtype=torch.int32,
                                       device=x.device)}
    return out.reshape(b, s, h * dh) @ params["wo"], new_cache
