"""RWKV-6 early-exit LM (reference ``src/repro/models/rwkv_model.py``;
attention-free, ``family == "rwkv"``).

No KV cache exists: each layer's state is O(1) in the sequence length (the
time mix's and the channel mix's token-shift vectors and the WKV matrix
state). An early exit skips the remaining layers' state updates.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.device import DeviceLike
from repro_torch.models.common import make_param, rms_norm
from repro_torch.models.rwkv6 import (
    RWKV6Config,
    channel_mix,
    init_channel_mix,
    init_time_mix,
    time_mix,
)
from repro_torch.models.transformer import (
    EarlyExitLM,
    LMConfig,
    layer_cache,
    remat_call,
    segment_sizes,
    stack_caches,
)


class RWKVBlock(nn.Module):
    def __init__(self, cfg: LMConfig, rcfg: RWKV6Config,
                 generator: torch.Generator):
        super().__init__()
        dt = cfg.dtype
        self.norm1 = make_param((cfg.d_model,), generator, init="ones",
                                dtype=dt, axes=("embed",))
        self.norm2 = make_param((cfg.d_model,), generator, init="ones",
                                dtype=dt, axes=("embed",))
        self.tm = nn.ParameterDict(init_time_mix(generator, rcfg, dt))
        self.cm = nn.ParameterDict(init_channel_mix(generator, rcfg, dt))


class RWKV6LM(EarlyExitLM):
    """Early-exit RWKV-6 LM."""

    def __init__(self, cfg: LMConfig,
                 generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None):
        if cfg.family != "rwkv":
            raise ValueError(f"RWKV6LM serves the rwkv family, not "
                             f"{cfg.family!r}")
        super().__init__(cfg, generator, device)
        self._draw_embedding()
        rcfg = self.rwkv_config()
        self.segments = nn.ModuleList(
            nn.ModuleList(RWKVBlock(cfg, rcfg, self._generator)
                          for _ in range(n))
            for n in segment_sizes(self.cfg))
        self._draw_unembedding()

    def rwkv_config(self) -> RWKV6Config:
        c = self.cfg
        return RWKV6Config(d_model=c.d_model, num_heads=c.num_heads,
                           d_ff=c.d_ff, chunk=c.rwkv_chunk)

    def _block_apply(self, blk: RWKVBlock, h: torch.Tensor,
                     state: Optional[dict]) -> Tuple[torch.Tensor, dict]:
        c, rcfg = self.cfg, self.rwkv_config()
        out, tm_new = time_mix(blk.tm, rms_norm(h, blk.norm1, c.norm_eps),
                               rcfg, None if state is None else state["tm"])
        h = h + out
        out, cm_new = channel_mix(blk.cm, rms_norm(h, blk.norm2, c.norm_eps),
                                  rcfg, None if state is None else state["cm"])
        return h + out, {"tm": tm_new, "cm": cm_new}

    def _run_segment(self, seg: int, h: torch.Tensor,
                     states: Optional[dict], keep_state: bool
                     ) -> Tuple[torch.Tensor, Optional[dict]]:
        new = []
        for i, blk in enumerate(self.segments[seg]):
            h, st = self._block_apply(
                blk, h, None if states is None else layer_cache(states, i))
            new.append(st)
        return h, (stack_caches(new) if keep_state else None)

    def _train_block(self, blk: RWKVBlock, h: torch.Tensor) -> torch.Tensor:
        return self._block_apply(blk, h, None)[0]

    def _train_trunk(self, batch: Dict[str, torch.Tensor]):
        """Every segment (blocks under ``remat_call``); returns (h at each
        exit, None: no MoE)."""
        h = self._embed(batch)
        hs = []
        for seg in self.segments:
            for blk in seg:
                h = remat_call(self._train_block, self.cfg.remat, blk, h)
            hs.append(h)
        return hs, None

    def trunk(self, batch: Dict[str, torch.Tensor], exit_idx: int,
              make_cache: bool = False):
        h = self._embed(batch)
        states = []
        for i in range(exit_idx + 1):
            h, st = self._run_segment(i, h, None, make_cache)
            states.append(st)
        return h, states if make_cache else None

    def decode_step(self, token: torch.Tensor, cache: dict, exit_idx: int
                    ) -> Tuple[torch.Tensor, dict]:
        """One token ``[B, 1]`` through exit ``exit_idx`` against the states
        of :meth:`init_cache` or ``prefill``; returns (float32 logits
        ``[B, 1, V_padded]``, the new states)."""
        self._check_cache(cache, exit_idx + 1, exit_idx)
        h = self._embed({"tokens": token})
        new = []
        for i in range(exit_idx + 1):
            h, st = self._run_segment(i, h, cache["segments"][i], True)
            new.append(st)
        return self._head(h, exit_idx), {"segments": new}

    def init_cache(self, batch_size: int, max_len: int, exit_idx: int,
                   dtype: Optional[torch.dtype] = None) -> dict:
        """Zero states per segment through exit ``exit_idx``: the shift
        vectors ``[n, B, D]`` in ``dtype`` and ``wkv`` ``[n, B, H, N, N]``
        float32. ``max_len`` is ignored: the state is O(1)."""
        c = self.cfg
        dtype = dtype or c.dtype
        device = self.embed.device
        n_head = self.rwkv_config().head_dim
        out = []
        for n in segment_sizes(self.cfg)[:exit_idx + 1]:
            out.append({
                "tm": {
                    "shift": torch.zeros((n, batch_size, c.d_model),
                                         dtype=dtype, device=device),
                    "wkv": torch.zeros((n, batch_size, c.num_heads, n_head,
                                        n_head), dtype=torch.float32,
                                       device=device)},
                "cm": {
                    "shift": torch.zeros((n, batch_size, c.d_model),
                                         dtype=dtype, device=device)}})
        return {"segments": out}
