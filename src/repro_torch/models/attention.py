"""Attention (reference ``src/repro/models/attention.py``): GQA with
optional per-head QK-norm, without a cache (training and prefill).

Shapes: activations are ``[B, S, D]``; query heads ``H``, kv heads ``K``
(GQA groups ``G = H // K``), head dim ``Dh``. The prefill hands back the
per-layer cache ``{"k": [B, S, K, Dh], "v": [B, S, K, Dh], "len": [B]}``.

The attention itself goes through the flash-attention kernel's wrapper
(the plain version on a CPU tensor, the CUDA kernel on a card tensor), with
``[B, H, S, Dh]`` views of the ``[B, S, H, Dh]`` activations: no copies.
``_sdpa`` is the plain path, the reference's jnp attention.

Decode (the cache branch) takes one token against a per-layer cache
``{"k": [B, Smax, K, Dh], "v": [B, Smax, K, Dh], "len": [B]}`` and goes
through the decode-attention kernel's wrapper, with ``[B, K, Smax, Dh]``
views of the cache. MLA waits for a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import sdpa_plain as _sdpa
from repro_torch.models.common import (
    make_param,
    prefix_rotation,
    rms_norm_pair,
    rope_rotation,
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
    """Self-attention forward.

    * Without a cache: attention over the whole of ``x`` (causal when
      ``cfg.causal``). When ``position`` is given (prefill), the fresh cache
      ``{"k", "v", "len"}`` is handed back; otherwise the cache is None.
    * Decode: ``x`` is one token ``[B, 1, D]`` and ``cache`` holds
      ``{"k", "v", "len"}``. Each row's q and k are rotated at that row's
      own position ``len``; the new k/v are written at row 0's length into
      every row (all rows share one length in the serving runtime), the
      start clamped to ``Smax - 1`` as ``jax.lax.dynamic_update_slice``
      clamps it; the token attends over ``len + 1`` positions. The write is
      in place: the returned cache holds the same k/v tensors and a new
      ``len + 1`` (the reference returns a new tree and donates the old one
      under ``jit``).
    """
    b, s, _ = x.shape
    if cache is not None and s != 1:
        raise ValueError(f"decode takes one token per row, got {s}")
    h, kh, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ params["wq"]).reshape(b, s, h, dh)
    k = (x @ params["wk"]).reshape(b, s, kh, dh)
    v = (x @ params["wv"]).reshape(b, s, kh, dh)
    if cfg.qk_norm:
        q, k = rms_norm_pair(q, params["q_norm"], k, params["k_norm"])
    if cache is not None:
        return _decode(params, q, k, v, cfg, cache)
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


def _decode(params, q, k, v, cfg: AttentionConfig, cache: dict
            ) -> Tuple[torch.Tensor, dict]:
    """The cache branch of :func:`attention` for q ``[B, 1, H, Dh]`` and
    k, v ``[B, 1, K, Dh]`` (reference ``attention.py:104-118``)."""
    b, _, h, dh = q.shape
    cache_len = cache["len"]                          # [B] int32
    rotation = rope_rotation(cache_len[:, None], dh, cfg.rope_theta)
    q = rotate(q, rotation)
    k = rotate(k, rotation)
    k_all, v_all = cache["k"], cache["v"]             # [B, Smax, K, Dh]
    # row 0's length on the device (no host sync), clamped into the cache
    idx = cache_len[:1].clamp(0, k_all.shape[1] - 1).long()
    k_all.index_copy_(1, idx, k.to(k_all.dtype))
    v_all.index_copy_(1, idx, v.to(v_all.dtype))
    new_len = cache_len + 1
    out = decode_attention(q[:, 0].to(k_all.dtype), k_all.transpose(1, 2),
                           v_all.transpose(1, 2), new_len)
    out = out.to(q.dtype).reshape(b, 1, h * dh) @ params["wo"]
    return out, {"k": k_all, "v": v_all, "len": new_len}
