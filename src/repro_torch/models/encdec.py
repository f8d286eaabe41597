"""Encoder-decoder early-exit LM (reference ``src/repro/models/encdec.py``;
the SeamlessM4T backbone, ``family == "encdec"``).

The audio frontend is a stub: the encoder takes precomputed frame
embeddings ``[B, S_src, D]``. The encoder is bidirectional with RoPE (the
flash-attention kernel, non-causal) and always runs whole; exits attach to
the decoder only. Each decoder layer runs causal self-attention (the
flash-attention kernel; the decode-attention kernel against its KV cache),
then cross-attention over the encoder's K/V, then the MLP.

Cross-attention of one query row (decode) is the decode-attention kernel
over all ``S_src`` source positions (``lengths = S_src``). Prefill's
cross-attention (``S_tgt != S_src`` queries) takes no kernel of the port
and stays the plain ``_sdpa``, as the reference computes it in jnp.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.device import DeviceLike
from repro_torch.kernels import checks
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.models.attention import _sdpa, attention, init_attention
from repro_torch.models.common import make_param, rms_norm
from repro_torch.models.moe import init_mlp, mlp
from repro_torch.models.transformer import (
    EarlyExitLM,
    LMConfig,
    layer_cache,
    remat_call,
    segment_sizes,
    stack_caches,
)


def init_cross_attention(generator: torch.Generator, cfg,
                         dtype: torch.dtype = torch.float32
                         ) -> Dict[str, torch.nn.Parameter]:
    d, h, kh, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "wq": make_param((d, h * dh), generator, dtype=dtype,
                         axes=("embed", "heads")),
        "wk": make_param((d, kh * dh), generator, dtype=dtype,
                         axes=("embed", "heads")),
        "wv": make_param((d, kh * dh), generator, dtype=dtype,
                         axes=("embed", "heads")),
        "wo": make_param((h * dh, d), generator, dtype=dtype,
                         axes=("heads", "embed")),
    }


def cross_attention(params, x: torch.Tensor, enc_kv: dict, cfg
                    ) -> torch.Tensor:
    """x ``[B, S_t, D]`` attends to the precomputed encoder K/V ``[B, S_src,
    K, Dh]`` (no positions, no mask)."""
    b, s, _ = x.shape
    h, dh = cfg.num_heads, cfg.head_dim
    q = (x @ params["wq"]).reshape(b, s, h, dh)
    k, v = enc_kv["k"], enc_kv["v"]
    if s == 1:  # one query row: the decode-attention kernel, all valid
        lengths = torch.full((b,), k.shape[1], dtype=torch.int32,
                             device=x.device)
        out = decode_attention(q[:, 0].to(k.dtype), k.transpose(1, 2),
                               v.transpose(1, 2), lengths).to(q.dtype)
    else:
        out = checks.partitioned("cross_attention", _sdpa, q, k, v,
                                 causal=False)
    return out.reshape(b, s, h * dh) @ params["wo"]


def encode_kv(params, enc_out: torch.Tensor, cfg) -> dict:
    """Project the encoder output once per session into cross-attention
    K/V ``[B, S_src, K, Dh]``."""
    b, s, _ = enc_out.shape
    kh, dh = cfg.num_kv_heads, cfg.head_dim
    return {"k": (enc_out @ params["wk"]).reshape(b, s, kh, dh),
            "v": (enc_out @ params["wv"]).reshape(b, s, kh, dh)}


class EncoderBlock(nn.Module):
    def __init__(self, cfg: LMConfig, generator: torch.Generator):
        super().__init__()
        dt = cfg.dtype
        self.norm1 = make_param((cfg.d_model,), generator, init="ones",
                                dtype=dt, axes=("embed",))
        self.norm2 = make_param((cfg.d_model,), generator, init="ones",
                                dtype=dt, axes=("embed",))
        self.attn = nn.ParameterDict(init_attention(generator,
                                                    cfg.attn_config(), dt))
        self.ffn = nn.ParameterDict(init_mlp(generator, cfg.mlp_config(), dt))


class DecoderBlock(nn.Module):
    def __init__(self, cfg: LMConfig, generator: torch.Generator):
        super().__init__()
        dt = cfg.dtype
        for name in ("norm1", "norm2", "norm3"):
            setattr(self, name, make_param((cfg.d_model,), generator,
                                           init="ones", dtype=dt,
                                           axes=("embed",)))
        self.attn = nn.ParameterDict(init_attention(generator,
                                                    cfg.attn_config(), dt))
        self.xattn = nn.ParameterDict(init_cross_attention(
            generator, cfg.attn_config(), dt))
        self.ffn = nn.ParameterDict(init_mlp(generator, cfg.mlp_config(), dt))


class EncDecLM(EarlyExitLM):
    """Early-exit encoder-decoder LM. A batch is ``{"src_embeds": [B,
    S_src, D], "tokens": [B, S_t]}``."""

    def __init__(self, cfg: LMConfig,
                 generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None):
        if cfg.family != "encdec" or cfg.num_encoder_layers <= 0:
            raise ValueError(f"EncDecLM serves the encdec family with "
                             f"encoder layers, not {cfg.family!r} with "
                             f"{cfg.num_encoder_layers}")
        super().__init__(cfg, generator, device)
        gen, dt = self._generator, cfg.dtype
        self._draw_embedding()
        self.enc_norm = make_param((cfg.d_model,), gen, init="ones",
                                   dtype=dt, axes=("embed",))
        self.encoder = nn.ModuleList(EncoderBlock(cfg, gen)
                                     for _ in range(cfg.num_encoder_layers))
        self.segments = nn.ModuleList(
            nn.ModuleList(DecoderBlock(cfg, gen) for _ in range(n))
            for n in segment_sizes(self.cfg))
        self._draw_unembedding()

    # -- encoder -------------------------------------------------------------

    def encode(self, src_embeds: torch.Tensor) -> torch.Tensor:
        """The whole bidirectional encoder over the frontend stub's
        embeddings, then its final norm."""
        c = self.cfg
        acfg = dataclasses.replace(c.attn_config(), causal=False)
        h = src_embeds.to(c.dtype)
        for blk in self.encoder:
            out, _ = attention(blk.attn, rms_norm(h, blk.norm1, c.norm_eps),
                               acfg)
            h = h + out
            h = h + mlp(blk.ffn, rms_norm(h, blk.norm2, c.norm_eps),
                        c.mlp_config())
        return rms_norm(h, self.enc_norm, c.norm_eps)

    # -- decoder -------------------------------------------------------------

    def _layer_apply(self, blk: DecoderBlock, h: torch.Tensor,
                     enc_out: Optional[torch.Tensor], cache: Optional[dict],
                     make_cache: bool) -> Tuple[torch.Tensor, Optional[dict]]:
        c = self.cfg
        acfg = c.attn_config()
        out, new_self = attention(
            blk.attn, rms_norm(h, blk.norm1, c.norm_eps), acfg,
            cache=None if cache is None else cache["self"],
            position=0 if make_cache else None)
        h = h + out
        enc_kv = (cache["enc_kv"] if cache is not None
                  else encode_kv(blk.xattn, enc_out, acfg))
        h = h + cross_attention(blk.xattn,
                                rms_norm(h, blk.norm2, c.norm_eps), enc_kv,
                                acfg)
        h = h + mlp(blk.ffn, rms_norm(h, blk.norm3, c.norm_eps),
                    c.mlp_config())
        if make_cache or cache is not None:
            return h, {"self": new_self, "enc_kv": enc_kv}
        return h, None

    def _run_segment(self, seg: int, h: torch.Tensor,
                     enc_out: Optional[torch.Tensor], caches: Optional[dict],
                     make_cache: bool) -> Tuple[torch.Tensor, Optional[dict]]:
        new = []
        for i, blk in enumerate(self.segments[seg]):
            h, cache = self._layer_apply(
                blk, h, enc_out,
                None if caches is None else layer_cache(caches, i),
                make_cache)
            new.append(cache)
        if caches is None and not make_cache:
            return h, None
        return h, stack_caches(new, caches)

    def _train_layer(self, blk: DecoderBlock, h: torch.Tensor,
                     enc_out: torch.Tensor) -> torch.Tensor:
        return self._layer_apply(blk, h, enc_out, None, False)[0]

    def _train_trunk(self, batch: Dict[str, torch.Tensor]):
        """The encoder, then every decoder segment (layers under
        ``remat_call``); returns (h at each exit, None: no MoE)."""
        enc_out = self.encode(batch["src_embeds"])
        h = self._embed(batch)
        hs = []
        for seg in self.segments:
            for blk in seg:
                h = remat_call(self._train_layer, self.cfg.remat, blk, h,
                               enc_out)
            hs.append(h)
        return hs, None

    def trunk(self, batch: Dict[str, torch.Tensor], exit_idx: int,
              make_cache: bool = False):
        enc_out = self.encode(batch["src_embeds"])
        h = self._embed(batch)
        caches = []
        for i in range(exit_idx + 1):
            h, seg_cache = self._run_segment(i, h, enc_out, None, make_cache)
            caches.append(seg_cache)
        return h, caches if make_cache else None

    def decode_step(self, token: torch.Tensor, cache: dict, exit_idx: int
                    ) -> Tuple[torch.Tensor, dict]:
        """One token ``[B, 1]`` through exit ``exit_idx`` against the
        self-attention KV cache (written in place) and the fixed
        cross-attention K/V of :meth:`prepare_decode_cache` or ``prefill``;
        returns (float32 logits ``[B, 1, V_padded]``, the new cache)."""
        self._check_cache(cache, exit_idx + 1, exit_idx)
        h = self._embed({"tokens": token})
        new = []
        for i in range(exit_idx + 1):
            h, seg_cache = self._run_segment(i, h, None,
                                             cache["segments"][i], False)
            new.append(seg_cache)
        return self._head(h, exit_idx), {"segments": new}

    def prepare_decode_cache(self, src_embeds: torch.Tensor, batch_size: int,
                             max_len: int, exit_idx: int) -> dict:
        """A fresh decode cache with every decoder layer's cross-attention
        K/V precomputed from the encoder output (once per serving session;
        the reference maps ``encode_kv`` over the stacked layers, the port
        loops over them)."""
        enc_out = self.encode(src_embeds)
        cache = self.init_cache(batch_size, max_len, exit_idx,
                                src_len=src_embeds.shape[1])
        acfg = self.cfg.attn_config()
        for seg, buf in zip(self.segments, cache["segments"]):
            for layer, blk in enumerate(seg):
                kv = encode_kv(blk.xattn, enc_out, acfg)
                buf["enc_kv"]["k"][layer] = kv["k"]
                buf["enc_kv"]["v"][layer] = kv["v"]
        return cache

    def init_cache(self, batch_size: int, max_len: int, exit_idx: int,
                   src_len: int = 0, dtype: Optional[torch.dtype] = None
                   ) -> dict:
        """Zero-filled cache per segment through exit ``exit_idx``:
        ``self`` {k, v ``[n, B, max_len, K, Dh]``, len ``[n, B]``} and
        ``enc_kv`` {k, v ``[n, B, src_len, K, Dh]``} (``src_len`` defaults
        to the config's ``frontend_seq``)."""
        c = self.cfg
        dtype = dtype or c.dtype
        device = self.embed.device
        src_len = src_len or max(c.frontend_seq, 1)
        out = []
        for n in segment_sizes(self.cfg)[:exit_idx + 1]:
            kv = (n, batch_size, max_len, c.num_kv_heads, c.head_dim_)
            src = (n, batch_size, src_len, c.num_kv_heads, c.head_dim_)
            out.append({
                "self": {
                    "k": torch.zeros(kv, dtype=dtype, device=device),
                    "v": torch.zeros(kv, dtype=dtype, device=device),
                    "len": torch.zeros((n, batch_size), dtype=torch.int32,
                                       device=device)},
                "enc_kv": {
                    "k": torch.zeros(src, dtype=dtype, device=device),
                    "v": torch.zeros(src, dtype=dtype, device=device)}})
        return {"segments": out}
