"""Jamba-style hybrid LM (reference ``src/repro/models/jamba_model.py``):
Mamba and attention at 1:7 with interleaved MoE.

Layers are grouped into *superblocks* of ``attn_period`` sublayers, keyed
``sub{j}``: one attention sublayer (at ``attn_offset``) and Mamba
sublayers otherwise, with the MoE on every ``moe_period``-th sublayer
(``j % moe_period == 1``) and the MLP on the rest. Exits sit on superblock
edges. The decode cache mixes the attention sublayers' KV cache with the
Mamba sublayers' ``h``/``conv`` states.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.device import DeviceLike
from repro_torch.models.attention import attention, init_attention
from repro_torch.models.common import ParamTree, make_param, rms_norm
from repro_torch.models.mamba import MambaConfig, init_mamba, mamba
from repro_torch.models.moe import init_mlp, init_moe, mlp, moe
from repro_torch.models.transformer import (
    EarlyExitLM,
    LMConfig,
    layer_cache,
    remat_call,
    segment_sizes,
    stack_caches,
)


def sub_kinds(cfg: LMConfig) -> List[Tuple[str, str]]:
    """Per sublayer within a superblock: (mixer, ffn) kinds."""
    return [("attn" if j == cfg.attn_offset else "mamba",
             "moe" if (cfg.moe_period and j % cfg.moe_period == 1)
             else "mlp")
            for j in range(cfg.attn_period)]


class Sublayer(nn.Module):
    """One sublayer's parameters: two norms, the mixer (attention or Mamba)
    and the feed-forward (MoE or MLP)."""

    def __init__(self, cfg: LMConfig, mcfg: MambaConfig,
                 generator: torch.Generator, mixer: str, ffn: str):
        super().__init__()
        dt = cfg.dtype
        self.norm1 = make_param((cfg.d_model,), generator, init="ones",
                                dtype=dt, axes=("embed",))
        self.norm2 = make_param((cfg.d_model,), generator, init="ones",
                                dtype=dt, axes=("embed",))
        self.mixer = ParamTree(
            init_attention(generator, cfg.attn_config(), dt)
            if mixer == "attn" else init_mamba(generator, mcfg, dt))
        self.ffn = ParamTree(
            init_moe(generator, cfg.moe_config(), dt) if ffn == "moe"
            else init_mlp(generator, cfg.mlp_config(), dt))


class JambaLM(EarlyExitLM):
    """Early-exit hybrid LM (``family == "jamba"``)."""

    def __init__(self, cfg: LMConfig,
                 generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None):
        if cfg.family != "jamba":
            raise ValueError(f"JambaLM serves the jamba family, not "
                             f"{cfg.family!r}")
        if cfg.attn_period <= 0 or cfg.num_layers % cfg.attn_period:
            raise ValueError(f"{cfg.num_layers} layers are not whole "
                             f"superblocks of {cfg.attn_period}")
        if any(e % cfg.attn_period for e in cfg.exits):
            raise ValueError("jamba exits must align to superblock "
                             "boundaries")
        super().__init__(cfg, generator, device)
        self._draw_embedding()
        mcfg = self.mamba_config()
        self.segments = nn.ModuleList(
            nn.ModuleList(
                nn.ModuleDict({
                    f"sub{j}": Sublayer(cfg, mcfg, self._generator, *kind)
                    for j, kind in enumerate(sub_kinds(self.cfg))})
                for _ in range(n))
            for n in segment_sizes(self.cfg))
        self._draw_unembedding()

    # -- structure ---------------------------------------------------------

    def mamba_config(self) -> MambaConfig:
        c = self.cfg
        return MambaConfig(d_model=c.d_model, d_state=c.mamba_d_state,
                           d_conv=c.mamba_d_conv, expand=c.mamba_expand)

    # -- forward -----------------------------------------------------------

    def sublayer_apply(self, sub: Sublayer, kind: Tuple[str, str],
                       h: torch.Tensor, cache: Optional[dict],
                       keep_state: bool
                       ) -> Tuple[torch.Tensor, Optional[dict]]:
        """One sublayer; with ``keep_state`` (prefill or decode) its new
        cache or state comes back, else None."""
        h, mc, _ = self._sublayer(sub, kind, h, cache, keep_state)
        return h, mc

    def _sublayer(self, sub: Sublayer, kind: Tuple[str, str],
                  h: torch.Tensor, cache: Optional[dict], keep_state: bool
                  ) -> Tuple[torch.Tensor, Optional[dict],
                             Optional[torch.Tensor]]:
        """:meth:`sublayer_apply` and the MoE aux loss (None for a dense
        feed-forward)."""
        c = self.cfg
        mixer, ffn = kind
        x = rms_norm(h, sub.norm1, c.norm_eps)
        if mixer == "attn":
            out, mc = attention(sub.mixer, x, c.attn_config(), cache=cache,
                                position=0 if keep_state and cache is None
                                else None)
        else:
            out, mc = mamba(sub.mixer, x, self.mamba_config(), state=cache)
        h = h + out
        x = rms_norm(h, sub.norm2, c.norm_eps)
        aux = None
        if ffn == "moe":
            out, aux = moe(sub.ffn, x, c.moe_config())
        else:
            out = mlp(sub.ffn, x, c.mlp_config())
        return h + out, (mc if keep_state else None), aux

    def _train_superblock(self, sb: nn.ModuleDict, h: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One superblock without states; returns (h, its MoE aux sum)."""
        aux_total = torch.zeros((), dtype=torch.float32, device=h.device)
        for j, kind in enumerate(sub_kinds(self.cfg)):
            h, _, aux = self._sublayer(sb[f"sub{j}"], kind, h, None, False)
            if aux is not None:
                aux_total = aux_total + aux
        return h, aux_total

    def _train_trunk(self, batch: Dict[str, torch.Tensor]):
        """Every segment (superblocks under ``remat_call``); returns (h at
        each exit, the MoE aux summed per segment, then over segments)."""
        h = self._embed(batch)
        zero = torch.zeros((), dtype=torch.float32, device=h.device)
        hs, aux_total = [], zero
        for seg in self.segments:
            seg_aux = zero
            for sb in seg:
                h, aux = remat_call(self._train_superblock, self.cfg.remat,
                                    sb, h)
                seg_aux = seg_aux + aux
            aux_total = aux_total + seg_aux
            hs.append(h)
        return hs, aux_total

    def _superblock_apply(self, sb: nn.ModuleDict, h: torch.Tensor,
                          cache: Optional[dict], keep_state: bool
                          ) -> Tuple[torch.Tensor, Optional[dict]]:
        new_cache: Dict[str, dict] = {}
        for j, kind in enumerate(sub_kinds(self.cfg)):
            key = f"sub{j}"
            h, mc = self.sublayer_apply(
                sb[key], kind, h, None if cache is None else cache[key],
                keep_state)
            if mc is not None:
                new_cache[key] = mc
        return h, (new_cache or None)

    def _run_segment(self, seg: int, h: torch.Tensor,
                     caches: Optional[dict], keep_state: bool
                     ) -> Tuple[torch.Tensor, Optional[dict]]:
        """One segment's superblocks. Decode gets each superblock's views
        of the stacked cache: the attention sublayers write their k/v in
        place and those buffers come back as they are; the lengths and the
        Mamba states come back new and are stacked."""
        new = []
        for i, sb in enumerate(self.segments[seg]):
            h, sc = self._superblock_apply(
                sb, h, None if caches is None else layer_cache(caches, i),
                keep_state)
            new.append(sc)
        return h, (stack_caches(new, caches) if keep_state else None)

    def trunk(self, batch: Dict[str, torch.Tensor], exit_idx: int,
              make_cache: bool = False):
        h = self._embed(batch)
        caches = []
        for i in range(exit_idx + 1):
            h, seg_cache = self._run_segment(i, h, None, make_cache)
            caches.append(seg_cache)
        return h, caches if make_cache else None

    def decode_step(self, token: torch.Tensor, cache: dict, exit_idx: int
                    ) -> Tuple[torch.Tensor, dict]:
        """One token ``[B, 1]`` through exit ``exit_idx`` against the mixed
        cache of :meth:`init_cache`; returns (float32 logits ``[B, 1,
        V_padded]``, the new cache)."""
        self._check_cache(cache, exit_idx + 1, exit_idx)
        h = self._embed({"tokens": token})
        new = []
        for i in range(exit_idx + 1):
            h, seg_cache = self._run_segment(i, h, cache["segments"][i],
                                             True)
            new.append(seg_cache)
        return self._head(h, exit_idx), {"segments": new}

    def init_cache(self, batch_size: int, max_len: int, exit_idx: int,
                   dtype: Optional[torch.dtype] = None) -> dict:
        """Zero-filled mixed cache per segment through exit ``exit_idx``:
        ``sub{j}`` holds k, v ``[n, B, max_len, K, Dh]`` and len ``[n, B]``
        for the attention sublayer, ``h`` ``[n, B, Di, N]`` (float32) and
        ``conv`` ``[n, B, K-1, Di]`` for a Mamba one."""
        c = self.cfg
        dtype = dtype or c.dtype
        device = self.embed.device
        mcfg = self.mamba_config()
        out = []
        for n in segment_sizes(self.cfg)[:exit_idx + 1]:
            sb = {}
            for j, (mixer, _) in enumerate(sub_kinds(self.cfg)):
                if mixer == "attn":
                    kv = (n, batch_size, max_len, c.num_kv_heads,
                          c.head_dim_)
                    sb[f"sub{j}"] = {
                        "k": torch.zeros(kv, dtype=dtype, device=device),
                        "v": torch.zeros(kv, dtype=dtype, device=device),
                        "len": torch.zeros((n, batch_size),
                                           dtype=torch.int32, device=device)}
                else:
                    sb[f"sub{j}"] = {
                        "h": torch.zeros((n, batch_size, mcfg.d_inner,
                                          mcfg.d_state), dtype=torch.float32,
                                         device=device),
                        "conv": torch.zeros((n, batch_size, mcfg.d_conv - 1,
                                             mcfg.d_inner), dtype=dtype,
                                            device=device)}
            out.append(sb)
        return {"segments": out}
