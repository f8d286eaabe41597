"""Decoder-only LM with scheduler-controlled early exits (reference
``src/repro/models/transformer.py``), dense GQA family.

The decoder stack is split into *segments* at the exit boundaries; each
segment is an ``nn.ModuleList`` of identical pre-norm blocks, run by a
Python loop (the reference scans a stacked segment with ``lax.scan``). An
exit head (per-exit RMSNorm + the shared unembedding) sits at each
boundary, so exiting early skips the remaining layers: the paper's latency
lever.

Three ways out of the trunk:

* ``forward_exit`` — every position's float32 logits (the reference's);
* ``prefill`` — the last position's logits plus the per-segment stacked KV
  caches (the reference's);
* ``exit_decision`` — the served quantum: the trunk, then the fused
  exit-head kernel on the last position, giving (top-1 token, max logit,
  logsumexp) without the ``[B, V]`` logits.

On the card the norms, the attention and the exit head are the port's CUDA
kernels; the large products (Q/K/V/O, the MLP, the logits of
``forward_exit``/``prefill``) stay ``torch.matmul``, as the reference leaves
them to XLA. The MoE and MLA families, ``decode_step`` and ``init_cache``
wait for later slices and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.exit_head.ops import exit_head
from repro_torch.models.attention import (
    AttentionConfig,
    attention,
    init_attention,
)
from repro_torch.models.common import make_param, mask_padded_vocab, rms_norm
from repro_torch.models.moe import MLPConfig, init_mlp, mlp


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """One config type for every LM architecture of the reference; every
    field is the reference's, ``dtype`` a torch dtype."""

    arch_id: str
    family: str                    # dense | moe | rwkv | jamba | encdec
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    exits: Tuple[int, ...]         # cumulative layer counts; last == num_layers
    head_dim: Optional[int] = None  # defaults to d_model // num_heads
    qk_norm: bool = False
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    mlp_gated: bool = True         # SwiGLU; starcoder2 uses plain GeLU
    norm_eps: float = 1e-6
    dtype: Any = torch.float32
    exit_loss_weights: Optional[Tuple[float, ...]] = None  # default: uniform
    remat: str = "none"            # none | dots | full (segment scan body)

    # MoE (family == "moe", or jamba's interleaved MoE)
    num_experts: int = 0
    top_k: int = 0
    num_shared_experts: int = 0
    d_ff_expert: int = 0
    moe_router: str = "softmax"
    dense_prefix: int = 0          # leading dense layers (deepseek: 1 / 3)
    moe_group_size: int = 1024
    moe_capacity_factor: float = 1.25

    # MLA (deepseek-v3)
    mla: bool = False
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    # rwkv (chunked-parallel WKV; 0 = stepwise scan baseline)
    rwkv_chunk: int = 0

    # MLA decode in absorbed-matrix form
    mla_absorbed_decode: bool = False

    # pad vocab so embedding/head shard over the model axis (0 = no
    # padding). Logits at padded slots are masked to -1e30.
    vocab_pad_multiple: int = 0

    # hybrid (jamba)
    attn_period: int = 0           # every Nth layer is attention (jamba: 8)
    attn_offset: int = 0           # index within the period
    moe_period: int = 0            # every Nth layer is MoE (jamba: 2)
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2

    # enc-dec (seamless)
    num_encoder_layers: int = 0

    # modality frontend stub: "none" | "audio" | "vision"
    frontend: str = "none"
    frontend_seq: int = 0          # frames/patches per example for stubs

    def __post_init__(self):
        if not self.exits:
            raise ValueError("at least one exit required")
        if self.exits[-1] != self.num_layers:
            raise ValueError("deepest exit must be the full stack")
        if tuple(sorted(set(self.exits))) != tuple(self.exits):
            raise ValueError(f"exits {self.exits} must increase strictly")
        if self.family == "moe" and not all(
                e > self.dense_prefix for e in self.exits):
            raise ValueError("exits must land in the MoE region")

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up to ``vocab_pad_multiple``."""
        m = self.vocab_pad_multiple
        if not m:
            return self.vocab_size
        return -(-self.vocab_size // m) * m

    @property
    def num_exits(self) -> int:
        return len(self.exits)

    @property
    def exit_weights_(self) -> Tuple[float, ...]:
        return self.exit_loss_weights or tuple([1.0] * len(self.exits))

    def attn_config(self) -> AttentionConfig:
        return AttentionConfig(
            d_model=self.d_model,
            num_heads=self.num_heads,
            num_kv_heads=self.num_kv_heads,
            head_dim=self.head_dim_,
            rope_theta=self.rope_theta,
            qk_norm=self.qk_norm,
        )

    def mlp_config(self) -> MLPConfig:
        return MLPConfig(d_model=self.d_model, d_ff=self.d_ff,
                         gated=self.mlp_gated)

    # -- segment plan --------------------------------------------------------

    def segments(self) -> List[Tuple[str, int, int]]:
        """[(kind, start_layer, end_layer)] split at exit boundaries and at
        the dense-prefix/MoE boundary. kind in {"dense", "moe"}."""
        bounds = [0]
        if self.dense_prefix:
            bounds.append(self.dense_prefix)
        bounds.extend(self.exits)
        bounds = sorted(set(bounds))
        segs = []
        for a, b in zip(bounds, bounds[1:]):
            kind = "dense" if (self.family != "moe" or b <= self.dense_prefix) \
                else "moe"
            segs.append((kind, a, b))
        return segs

    def exit_segment_index(self, exit_idx: int) -> int:
        """Number of segments to run (inclusive) for a given exit."""
        target = self.exits[exit_idx]
        for i, (_, _, end) in enumerate(self.segments()):
            if end == target:
                return i + 1
        raise ValueError(f"exit {exit_idx} not on a segment boundary")


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


class Block(nn.Module):
    """One pre-norm dense block: norms, attention and MLP parameters."""

    def __init__(self, cfg: LMConfig, generator: torch.Generator):
        super().__init__()
        dt = cfg.dtype
        self.norm1 = make_param((cfg.d_model,), generator, init="ones",
                                dtype=dt)
        self.norm2 = make_param((cfg.d_model,), generator, init="ones",
                                dtype=dt)
        self.attn = nn.ParameterDict(init_attention(generator,
                                                    cfg.attn_config(), dt))
        self.ffn = nn.ParameterDict(init_mlp(generator, cfg.mlp_config(), dt))


def _block_apply(blk: Block, h: torch.Tensor, cfg: LMConfig,
                 make_cache: bool) -> Tuple[torch.Tensor, Optional[dict]]:
    """One pre-norm block. Returns (h, new_cache)."""
    attn_in = rms_norm(h, blk.norm1, cfg.norm_eps)
    attn_out, new_cache = attention(
        blk.attn, attn_in, cfg.attn_config(),
        position=0 if make_cache else None)
    h = h + attn_out
    ffn_in = rms_norm(h, blk.norm2, cfg.norm_eps)
    return h + mlp(blk.ffn, ffn_in, cfg.mlp_config()), new_cache


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


class DecoderLM(nn.Module):
    """Early-exit decoder LM, dense family.

    Weights are drawn from ``generator`` (default: seed 0 on ``device``) at
    the reference's scales, directly on ``device`` (the card unless the
    caller passes ``"cpu"``), in ``cfg.dtype``. Parameters are frozen: this
    slice serves and does not train.
    """

    def __init__(self, cfg: LMConfig,
                 generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None):
        super().__init__()
        if cfg.family != "dense" or cfg.mla:
            raise NotImplementedError(
                f"family {cfg.family!r}{' with MLA' if cfg.mla else ''} is "
                f"not ported yet; this slice carries the dense family")
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        if generator.device.type != device.type:
            raise ValueError(f"generator is on {generator.device}, the model "
                             f"on {device}")
        self.cfg = cfg
        dt = cfg.dtype
        self.embed = make_param((cfg.vocab_padded, cfg.d_model), generator,
                                init="embedding", dtype=dt)
        self.exit_norms = nn.ParameterList(
            make_param((cfg.d_model,), generator, init="ones", dtype=dt)
            for _ in range(cfg.num_exits))
        self.segments = nn.ModuleList(
            nn.ModuleList(Block(cfg, generator) for _ in range(end - start))
            for _, start, end in cfg.segments())
        if not cfg.tie_embeddings:
            self.lm_head = make_param((cfg.d_model, cfg.vocab_padded),
                                      generator, dtype=dt)
        self._head_w: Optional[torch.Tensor] = None
        self.register_load_state_dict_post_hook(
            lambda module, _keys: module._drop_head_copy())

    def _drop_head_copy(self) -> None:
        self._head_w = None

    def _apply(self, fn, recurse=True):
        self._head_w = None  # a device or dtype move invalidates the copy
        return super()._apply(fn, recurse)

    # -- helpers -----------------------------------------------------------

    def _embed(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        if "embeds" in batch:  # modality frontend stub output (vlm/audio)
            return batch["embeds"].to(self.cfg.dtype)
        return self.embed[batch["tokens"]]

    def _unembedding(self) -> torch.Tensor:
        """W ``[D, V_padded]`` as the reference's ``_head`` multiplies."""
        return self.embed.T if self.cfg.tie_embeddings else self.lm_head

    def exit_head_weight(self) -> torch.Tensor:
        """Contiguous ``[D, V]`` unembedding for the exit-head kernel.

        Untied and unpadded, that is ``lm_head`` itself. Otherwise (tied
        embeddings: ``embed.T``; a padded vocab: the first V columns) the
        model keeps its own contiguous copy, made at first use and dropped
        when the weights are loaded or moved: V * D elements more (56.6 MB
        for SmolLM-135M in bfloat16).
        """
        cfg = self.cfg
        if not cfg.tie_embeddings and cfg.vocab_padded == cfg.vocab_size:
            return self.lm_head
        if self._head_w is None:
            self._head_w = self._unembedding()[:, :cfg.vocab_size].contiguous()
        return self._head_w

    def _head(self, h: torch.Tensor, exit_idx: int) -> torch.Tensor:
        cfg = self.cfg
        h = rms_norm(h, self.exit_norms[exit_idx], cfg.norm_eps)
        logits = (h @ self._unembedding().to(h.dtype)).to(torch.float32)
        return mask_padded_vocab(logits, cfg.vocab_size)

    def _run_segment(self, seg: int, h: torch.Tensor, make_cache: bool
                     ) -> Tuple[torch.Tensor, Optional[dict]]:
        """Run one segment's blocks in order. With ``make_cache`` the
        per-layer caches come back stacked on a leading layers axis, as the
        reference's scan stacks them."""
        caches = []
        for blk in self.segments[seg]:
            h, cache = _block_apply(blk, h, self.cfg, make_cache)
            caches.append(cache)
        if not make_cache:
            return h, None
        return h, {key: torch.stack([c[key] for c in caches])
                   for key in ("k", "v", "len")}

    def trunk(self, batch: Dict[str, torch.Tensor], exit_idx: int,
              make_cache: bool = False):
        """Embed and run the segments up to exit ``exit_idx``; returns
        (h ``[B, S, D]``, per-segment caches or None)."""
        h = self._embed(batch)
        caches = []
        for i in range(self.cfg.exit_segment_index(exit_idx)):
            h, seg_cache = self._run_segment(i, h, make_cache)
            caches.append(seg_cache)
        return h, caches if make_cache else None

    # -- serving -----------------------------------------------------------

    def forward_exit(self, batch: Dict[str, torch.Tensor],
                     exit_idx: int) -> torch.Tensor:
        """Run layers up to ``exits[exit_idx]`` and that exit's head:
        float32 logits ``[B, S, V_padded]``."""
        h, _ = self.trunk(batch, exit_idx)
        return self._head(h, exit_idx)

    def prefill(self, batch: Dict[str, torch.Tensor], exit_idx: int):
        """Prefill through exit ``exit_idx``: logits for the last position
        ``[B, 1, V_padded]`` + per-segment stacked KV caches (sized to the
        prompt)."""
        h, caches = self.trunk(batch, exit_idx, make_cache=True)
        logits = self._head(h[:, -1:, :], exit_idx)
        return logits, {"segments": caches}

    def exit_decision(self, batch: Dict[str, torch.Tensor], exit_idx: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The served quantum: the trunk through exit ``exit_idx``, then the
        fused exit head on the last position. Returns (top-1 token ``[B]``
        int32, max logit ``[B]`` float32, logsumexp ``[B]`` float32), the
        argmax, max and logsumexp of ``prefill``'s logits;
        confidence = exp(max - lse)."""
        h, _ = self.trunk(batch, exit_idx)
        return exit_head(h[:, -1, :].contiguous(), self.exit_norms[exit_idx],
                         self.exit_head_weight(), eps=self.cfg.norm_eps)

    def decode_step(self, token, cache, exit_idx: int):
        raise NotImplementedError(
            "decode_step (the KV-cache path and the decode-attention kernel) "
            "is the next slice of the port")

    def init_cache(self, batch_size: int, max_len: int, exit_idx: int,
                   dtype=None):
        raise NotImplementedError(
            "init_cache (the KV-cache path) is the next slice of the port")
