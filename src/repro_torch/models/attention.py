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
views of the cache.

MLA (DeepSeek-V3's multi-head latent attention) caches the compressed
latent ``{"c_kv": [B, Smax, d_c], "k_pe": [B, Smax, r], "len": [B]}``. Its
q/k head dim (nope + rope = 192) differs from its v head dim (128), which
no kernel of the port takes, so its attention is the plain ``_sdpa`` (the
reference computes it in jnp); its two latent norms are RMSNorm kernel
launches. ``mla_attention_absorbed`` is the absorbed-matrix decode, in
plain torch ops.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import checks
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import sdpa_plain as _sdpa
from repro_torch.models.common import (
    make_param,
    prefix_rotation,
    rms_norm,
    rms_norm_pair,
    rope_rotation,
    rotate,
)

__all__ = ["AttentionConfig", "MLAConfig", "attention", "init_attention",
           "init_mla", "mla_attention", "mla_attention_absorbed", "_sdpa"]


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
        "wq": make_param((d, h * dh), generator, dtype=dtype,
                         axes=("embed", "heads")),
        "wk": make_param((d, k_h * dh), generator, dtype=dtype,
                         axes=("embed", "heads")),
        "wv": make_param((d, k_h * dh), generator, dtype=dtype,
                         axes=("embed", "heads")),
        "wo": make_param((h * dh, d), generator, dtype=dtype,
                         axes=("heads", "embed")),
    }
    if cfg.qk_norm:
        params["q_norm"] = make_param((dh,), generator, init="ones",
                                      dtype=dtype, axes=(None,))
        params["k_norm"] = make_param((dh,), generator, init="ones",
                                      dtype=dtype, axes=(None,))
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
    _write_at_row0(cache_len, (k_all, k), (v_all, v))
    new_len = cache_len + 1
    out = decode_attention(q[:, 0].to(k_all.dtype), k_all.transpose(1, 2),
                           v_all.transpose(1, 2), new_len)
    out = out.to(q.dtype).reshape(b, 1, h * dh) @ params["wo"]
    return out, {"k": k_all, "v": v_all, "len": new_len}


def _write_at_row0(cache_len: torch.Tensor, *pairs) -> None:
    """Write each ``(buffer [B, Smax, ...], new [B, 1, ...])`` pair at row
    0's length in every row (all rows share one length in the serving
    runtime), on the device with no host sync; the start is clamped to
    ``Smax - 1`` as ``jax.lax.dynamic_update_slice`` clamps it."""
    for buf, new in pairs:
        idx = cache_len[:1].clamp(0, buf.shape[1] - 1).long()
        buf.index_copy_(1, idx, new.to(buf.dtype))


# ---------------------------------------------------------------------------
# Multi-head Latent Attention (DeepSeek-V3)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    d_model: int
    num_heads: int
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rope_theta: float = 10000.0
    causal: bool = True

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim


def init_mla(generator: torch.Generator, cfg: MLAConfig,
             dtype: torch.dtype = torch.float32
             ) -> Dict[str, torch.nn.Parameter]:
    d, h = cfg.d_model, cfg.num_heads
    return {
        # low-rank query path: d -> q_lora -> heads * (nope + rope)
        "wq_a": make_param((d, cfg.q_lora_rank), generator, dtype=dtype,
                           axes=("embed", None)),
        "q_a_norm": make_param((cfg.q_lora_rank,), generator, init="ones",
                               dtype=dtype, axes=(None,)),
        "wq_b": make_param((cfg.q_lora_rank, h * cfg.qk_head_dim),
                           generator, dtype=dtype, axes=(None, "heads")),
        # compressed kv path: d -> kv_lora (+ the shared rope key)
        "wkv_a": make_param((d, cfg.kv_lora_rank + cfg.qk_rope_head_dim),
                            generator, dtype=dtype, axes=("embed", None)),
        "kv_a_norm": make_param((cfg.kv_lora_rank,), generator, init="ones",
                                dtype=dtype, axes=(None,)),
        "wkv_b": make_param(
            (cfg.kv_lora_rank, h * (cfg.qk_nope_head_dim + cfg.v_head_dim)),
            generator, dtype=dtype, axes=(None, "heads")),
        "wo": make_param((h * cfg.v_head_dim, d), generator, dtype=dtype,
                         axes=("heads", "embed")),
    }


def _mla_q(params, x: torch.Tensor, cfg: MLAConfig, rotation
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q_nope ``[B, S, H, dn]``, rotated q_pe ``[B, S, H, r]``)."""
    b, s, _ = x.shape
    q = rms_norm(x @ params["wq_a"], params["q_a_norm"]) @ params["wq_b"]
    q = q.reshape(b, s, cfg.num_heads, cfg.qk_head_dim)
    q_nope, q_pe = q.split([cfg.qk_nope_head_dim, cfg.qk_rope_head_dim], -1)
    return q_nope, rotate(q_pe, rotation)


def _mla_latent(params, x: torch.Tensor, cfg: MLAConfig, rotation
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(normed latent c_kv ``[B, S, d_c]``, rotated k_pe ``[B, S, r]``)."""
    c_kv, k_pe = (x @ params["wkv_a"]).split(
        [cfg.kv_lora_rank, cfg.qk_rope_head_dim], -1)
    c_kv = rms_norm(c_kv, params["kv_a_norm"])
    return c_kv, rotate(k_pe[:, :, None, :], rotation)[:, :, 0, :]


def _mla_attend(q: torch.Tensor, c_kv: torch.Tensor, k_pe: torch.Tensor,
                wkv_b: torch.Tensor, dn: int, dv: int, causal: bool,
                kv_len: Optional[torch.Tensor] = None,
                **split) -> torch.Tensor:
    """MLA's attention proper: q ``[B, S, H, dn + r]`` over per-head keys
    and values expanded from the latent c_kv ``[B, T, d_c]`` by wkv_b
    ``[d_c, H * (dn + dv)]``, the shared rope key k_pe ``[B, T, r]``
    broadcast over the heads. Returns ``[B, S, H, dv]``. The heads are
    wkv_b's (a device's shard of them under the cost counter's partition,
    ``launch/graph_analysis.py::_mla_partition``); ``split`` (``_sdpa``'s
    ``kv_offset`` and ``softmax``) attends over one slice of the keys
    there."""
    k, v = _mla_kv(c_kv, k_pe, wkv_b, dn, dv)
    return _sdpa(q, k, v, causal, kv_len=kv_len, **split)


def _mla_kv(c_kv: torch.Tensor, k_pe: torch.Tensor, wkv_b: torch.Tensor,
            dn: int, dv: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-head (k ``[B, T, H, dn + r]``, v ``[B, T, H, dv]``) from the
    latent and the shared rope key (:func:`_mla_attend`)."""
    b, t, _ = c_kv.shape
    h = wkv_b.shape[-1] // (dn + dv)
    kv = (c_kv @ wkv_b).reshape(b, t, h, dn + dv)
    k_nope, v = kv.split([dn, dv], -1)
    k_pe = k_pe[:, :, None, :].expand(b, t, h, k_pe.shape[-1])
    return torch.cat([k_nope, k_pe], -1), v


def mla_attention(params, x: torch.Tensor, cfg: MLAConfig,
                  cache: Optional[dict] = None, position=None
                  ) -> Tuple[torch.Tensor, Optional[dict]]:
    """MLA forward (reference ``attention.py:197``). Without a cache,
    attention over the whole of ``x`` (the prefill hands back ``{"c_kv",
    "k_pe", "len"}`` when ``position`` is given). With one, ``x`` is one
    token: its latent and rope key are written at row 0's length in place,
    the cached latent is expanded into per-head K/V, and the token attends
    over ``len + 1`` positions."""
    b, s, _ = x.shape
    h = cfg.num_heads
    if cache is None:
        rotation = prefix_rotation(s, cfg.qk_rope_head_dim, cfg.rope_theta,
                                   x.device)
        q_nope, q_pe = _mla_q(params, x, cfg, rotation)
        c_kv, k_pe = _mla_latent(params, x, cfg, rotation)
        out = checks.partitioned(
            "mla_attention", _mla_attend, torch.cat([q_nope, q_pe], -1),
            c_kv, k_pe, params["wkv_b"], cfg.qk_nope_head_dim,
            cfg.v_head_dim, cfg.causal)
        new_cache = None
        if position is not None:
            new_cache = {"c_kv": c_kv, "k_pe": k_pe,
                         "len": torch.full((b,), s, dtype=torch.int32,
                                           device=x.device)}
    else:
        if s != 1:
            raise ValueError(f"decode takes one token per row, got {s}")
        cache_len = cache["len"]
        rotation = rope_rotation(cache_len[:, None], cfg.qk_rope_head_dim,
                                 cfg.rope_theta)
        q_nope, q_pe = _mla_q(params, x, cfg, rotation)
        c_new, pe_new = _mla_latent(params, x, cfg, rotation)
        c_all, pe_all = cache["c_kv"], cache["k_pe"]
        _write_at_row0(cache_len, (c_all, c_new), (pe_all, pe_new))
        out = checks.partitioned(
            "mla_attention", _mla_attend, torch.cat([q_nope, q_pe], -1),
            c_all.to(x.dtype), pe_all.to(x.dtype), params["wkv_b"],
            cfg.qk_nope_head_dim, cfg.v_head_dim, False,
            kv_len=cache_len + 1)
        new_cache = {"c_kv": c_all, "k_pe": pe_all, "len": cache_len + 1}
    return out.reshape(b, s, h * cfg.v_head_dim) @ params["wo"], new_cache


def mla_attention_absorbed(params, x: torch.Tensor, cfg: MLAConfig,
                           cache: dict) -> Tuple[torch.Tensor, dict]:
    """Absorbed-matrix MLA decode (reference ``attention.py:244``): the
    nope-query goes through W_k into the latent, scores are taken against
    the cached latent directly, and the context is expanded through W_v for
    the one token. The same function as :func:`mla_attention`'s decode;
    the cache is written in place as there."""
    b, s, _ = x.shape
    if s != 1:
        raise ValueError(f"decode takes one token per row, got {s}")
    h = cfg.num_heads
    dn, dv, dc = cfg.qk_nope_head_dim, cfg.v_head_dim, cfg.kv_lora_rank
    cache_len = cache["len"]
    rotation = rope_rotation(cache_len[:, None], cfg.qk_rope_head_dim,
                             cfg.rope_theta)
    q_nope, q_pe = _mla_q(params, x, cfg, rotation)
    c_new, pe_new = _mla_latent(params, x, cfg, rotation)
    c_all, pe_all = cache["c_kv"], cache["k_pe"]
    _write_at_row0(cache_len, (c_all, c_new), (pe_all, pe_new))
    c, pe = c_all.to(x.dtype), pe_all.to(x.dtype)

    wkv_b = params["wkv_b"].reshape(dc, h, dn + dv)
    w_k, w_v = wkv_b[..., :dn], wkv_b[..., dn:]
    q_eff = torch.einsum("bshd,chd->bshc", q_nope, w_k)       # [B,1,H,dc]
    scores = (torch.einsum("bshc,btc->bhst", q_eff, c)
              + torch.einsum("bshr,btr->bhst", q_pe, pe)).to(torch.float32)
    scores = scores * (1.0 / torch.sqrt(torch.tensor(
        float(cfg.qk_head_dim)))).item()
    valid = (torch.arange(c.shape[1], device=x.device)[None, :]
             < (cache_len + 1)[:, None])
    scores = scores.masked_fill(~valid[:, None, None, :], -1e30)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    o_latent = torch.einsum("bhst,btc->bshc", probs, c)       # [B,1,H,dc]
    out = torch.einsum("bshc,chd->bshd", o_latent, w_v)       # [B,1,H,dv]
    out = out.reshape(b, s, h * dv) @ params["wo"]
    return out, {"c_kv": c_all, "k_pe": pe_all, "len": cache_len + 1}
