"""Decoder-only LM with scheduler-controlled early exits (reference
``src/repro/models/transformer.py``): the dense GQA family and the MoE
family, with MLA where the config asks for it.

The decoder stack is split into *segments* at the exit boundaries; each
segment is an ``nn.ModuleList`` of identical pre-norm blocks, run by a
Python loop (the reference scans a stacked segment with ``lax.scan``). An
exit head (per-exit RMSNorm + the shared unembedding) sits at each
boundary, so exiting early skips the remaining layers: the paper's latency
lever.

Four ways out of the trunk:

* ``forward_exit`` — every position's float32 logits (the reference's);
* ``prefill`` — the last position's logits plus the per-segment stacked KV
  caches (the reference's);
* ``exit_decision`` — the served quantum: the trunk, then the fused
  exit-head kernel on the last position, giving (top-1 token, max logit,
  logsumexp) without the ``[B, V]`` logits;
* ``decode_step`` — one token against the cache of ``init_cache`` (the
  reference's), written in place.

On the card the norms, the GQA attention (prefill and decode) and the exit
head are the port's CUDA kernels; the large products (Q/K/V/O, the MLP, the
logits of ``forward_exit``/``prefill``/``decode_step``) stay
``torch.matmul``, as the reference leaves them to XLA, and so do the MoE's
einsums and MLA's attention (see ``moe.py`` and ``attention.py``).

``EarlyExitLM`` holds what every family shares (the embedding, the exit
norms, the unembedding, ``forward_exit``, ``prefill`` and the served
quantum ``exit_decision``); a family gives its ``trunk``, ``decode_step``
and ``init_cache``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import checks
from repro_torch.kernels.exit_head.ops import exit_head
from repro_torch.models.attention import (
    AttentionConfig,
    MLAConfig,
    attention,
    init_attention,
    init_mla,
    mla_attention,
    mla_attention_absorbed,
)
from repro_torch.models.common import (
    ParamTree,
    cross_entropy,
    make_param,
    mask_padded_vocab,
    meta_generator,
    rms_norm,
    weighted_exit_loss,
)
from repro_torch.models.moe import (
    MLPConfig,
    MoEConfig,
    init_mlp,
    init_moe,
    mlp,
    moe,
)


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

    def mla_config(self) -> MLAConfig:
        return MLAConfig(
            d_model=self.d_model,
            num_heads=self.num_heads,
            q_lora_rank=self.q_lora_rank,
            kv_lora_rank=self.kv_lora_rank,
            qk_nope_head_dim=self.qk_nope_head_dim,
            qk_rope_head_dim=self.qk_rope_head_dim,
            v_head_dim=self.v_head_dim,
            rope_theta=self.rope_theta,
        )

    def mlp_config(self) -> MLPConfig:
        return MLPConfig(d_model=self.d_model, d_ff=self.d_ff,
                         gated=self.mlp_gated)

    def moe_config(self) -> MoEConfig:
        return MoEConfig(
            d_model=self.d_model,
            d_ff_expert=self.d_ff_expert,
            num_experts=self.num_experts,
            top_k=self.top_k,
            num_shared=self.num_shared_experts,
            router_type=self.moe_router,
            group_size=self.moe_group_size,
            capacity_factor=self.moe_capacity_factor,
        )

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


def segment_sizes(cfg: LMConfig) -> List[int]:
    """Stacked blocks per exit segment of ``cfg``'s family: layers for the
    dense, MoE, RWKV and encoder-decoder families, superblocks for Jamba."""
    if cfg.family == "jamba":
        bounds = [0] + [e // cfg.attn_period for e in cfg.exits]
    elif cfg.family in ("rwkv", "encdec"):
        bounds = [0] + list(cfg.exits)
    else:
        return [end - start for _, start, end in cfg.segments()]
    return [b - a for a, b in zip(bounds, bounds[1:])]


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


class Block(nn.Module):
    """One pre-norm block's parameters: norms, attention (GQA or MLA) and
    the feed-forward of its kind (``"dense"``: the MLP, ``"moe"``: the
    MoE)."""

    def __init__(self, cfg: LMConfig, generator: torch.Generator,
                 kind: str = "dense"):
        super().__init__()
        dt = cfg.dtype
        self.kind = kind
        self.norm1 = make_param((cfg.d_model,), generator, init="ones",
                                dtype=dt, axes=("embed",))
        self.norm2 = make_param((cfg.d_model,), generator, init="ones",
                                dtype=dt, axes=("embed",))
        self.attn = nn.ParameterDict(
            init_mla(generator, cfg.mla_config(), dt) if cfg.mla
            else init_attention(generator, cfg.attn_config(), dt))
        self.ffn = ParamTree(
            init_moe(generator, cfg.moe_config(), dt) if kind == "moe"
            else init_mlp(generator, cfg.mlp_config(), dt))


def _block_apply(blk: Block, h: torch.Tensor, cfg: LMConfig,
                 make_cache: bool, cache: Optional[dict] = None
                 ) -> Tuple[torch.Tensor, Optional[dict], torch.Tensor]:
    """One pre-norm block, decoding against ``cache`` when one is given.
    Returns (h, new_cache, the MoE aux loss; 0 for a dense block)."""
    attn_in = rms_norm(h, blk.norm1, cfg.norm_eps)
    position = 0 if make_cache else None
    if cfg.mla and cfg.mla_absorbed_decode and cache is not None:
        attn_out, new_cache = mla_attention_absorbed(
            blk.attn, attn_in, cfg.mla_config(), cache=cache)
    elif cfg.mla:
        attn_out, new_cache = mla_attention(
            blk.attn, attn_in, cfg.mla_config(), cache=cache,
            position=position)
    else:
        attn_out, new_cache = attention(
            blk.attn, attn_in, cfg.attn_config(), cache=cache,
            position=position)
    h = h + attn_out
    ffn_in = rms_norm(h, blk.norm2, cfg.norm_eps)
    if blk.kind == "moe":
        ffn_out, aux = moe(blk.ffn, ffn_in, cfg.moe_config())
    else:
        ffn_out = mlp(blk.ffn, ffn_in, cfg.mlp_config())
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return h + ffn_out, new_cache, aux


def remat_call(fn, remat: str, *args):
    """``fn(*args)``; where ``remat`` is not ``"none"`` and a gradient is
    being taken, under ``torch.utils.checkpoint``, so that the backward
    recomputes ``fn``'s activations instead of keeping them. The reference's
    ``"dots"`` policy keeps the products' outputs and recomputes the rest;
    here ``"dots"`` and ``"full"`` alike recompute the whole of ``fn`` (a
    block): the gradient is the same, only memory and time change. The
    recomputation launches the block's forward kernels a second time.
    ``fn``'s first argument after the block is the hidden state the layer
    loop carries; a cost count over ``DTensor``s keeps its sharding from
    block to block (``launch/graph_analysis.py::_layer_partition``)."""
    return checks.partitioned("layer", _remat_call, fn, remat, *args)


def _remat_call(fn, remat: str, *args):
    if remat == "none" or not torch.is_grad_enabled():
        return fn(*args)
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)


def stack_caches(caches: List[dict], into: Optional[dict] = None) -> dict:
    """Per-layer caches (nested dicts of tensors) stacked on a leading
    layers axis, as the reference's scan stacks them. Where every layer's
    tensor is its view of the stacked ``into`` (a decode step wrote it in
    place), ``into``'s tensor comes back as it is, without a copy."""
    out = {}
    for key, first in caches[0].items():
        parts = [c[key] for c in caches]
        held = None if into is None else into[key]
        if isinstance(first, dict):
            out[key] = stack_caches(parts, held)
        elif held is not None and all(
                p.data_ptr() == held[i].data_ptr()
                and p.shape == held[i].shape for i, p in enumerate(parts)):
            out[key] = held
        else:
            out[key] = torch.stack(parts)
    return out


def layer_cache(caches: dict, layer: int) -> dict:
    """Layer ``layer``'s views of a stacked cache: writes into them land in
    the stack."""
    return {key: (layer_cache(value, layer) if isinstance(value, dict)
                  else value[layer])
            for key, value in caches.items()}


# ---------------------------------------------------------------------------
# The models
# ---------------------------------------------------------------------------


class EarlyExitLM(nn.Module):
    """What every early-exit LM family shares: the embedding, one RMSNorm
    gain per exit, the shared unembedding and the ways out of the trunk.

    Weights are drawn from ``generator`` (default: seed 0 on ``device``) at
    the reference's scales, directly on ``device`` (the card unless the
    caller passes ``"cpu"``), in ``cfg.dtype``, with
    ``requires_grad=False``: serving builds no graph. Training turns
    gradients on only for the float32 master values the trainer owns
    (``repro_torch.runtime.trainer``), and runs :meth:`train_loss` on them
    cast to ``cfg.dtype`` in place of these parameters (the serving build's
    own parameters never change). A family sets its parameters up in
    ``__init__`` (``_draw_embedding`` and ``_draw_unembedding`` draw the
    shared ones) and defines ``trunk(batch, exit_idx, make_cache=False)``:
    the layers up to exit ``exit_idx``, returning (h ``[B, S, D]``, the
    per-segment caches or None without ``make_cache``), and
    ``_train_trunk(batch)``: every layer, returning (h at each exit, the
    summed MoE aux loss or None where the family has no MoE).
    """

    def __init__(self, cfg: LMConfig,
                 generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = (meta_generator() if device.type == "meta" else
                         torch.Generator(device=device).manual_seed(0))
        if generator.device.type != device.type:
            raise ValueError(f"generator is on {generator.device}, the model "
                             f"on {device}")
        self.cfg = cfg
        self._generator = generator
        self._head_w: Optional[torch.Tensor] = None
        self.register_load_state_dict_post_hook(
            lambda module, _keys: module._drop_head_copy())

    def _draw_embedding(self) -> None:
        cfg, gen = self.cfg, self._generator
        self.embed = make_param((cfg.vocab_padded, cfg.d_model), gen,
                                init="embedding", dtype=cfg.dtype,
                                axes=("vocab", "embed"))
        self.exit_norms = nn.ParameterList(
            make_param((cfg.d_model,), gen, init="ones", dtype=cfg.dtype,
                       axes=("embed",))
            for _ in range(cfg.num_exits))

    def _draw_unembedding(self) -> None:
        cfg = self.cfg
        if not cfg.tie_embeddings:
            self.lm_head = make_param((cfg.d_model, cfg.vocab_padded),
                                      self._generator, dtype=cfg.dtype,
                                      axes=("embed", "vocab"))
        del self._generator

    def _drop_head_copy(self) -> None:
        self._head_w = None

    def _apply(self, fn, recurse=True):
        self._head_w = None  # a device or dtype move invalidates the copy
        return super()._apply(fn, recurse)

    # -- helpers -----------------------------------------------------------

    def _embed(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
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
        logits = checks.partitioned("unembed", torch.matmul, h,
                                    self._unembedding().to(h.dtype))
        logits = logits.to(torch.float32)
        return mask_padded_vocab(logits, cfg.vocab_size)

    # -- serving -----------------------------------------------------------

    def forward_exit(self, batch: Dict[str, torch.Tensor],
                     exit_idx: int) -> torch.Tensor:
        """Run layers up to ``exits[exit_idx]`` and that exit's head:
        float32 logits ``[B, S, V_padded]``."""
        h, _ = self.trunk(batch, exit_idx)
        return self._head(h, exit_idx)

    def prefill(self, batch: Dict[str, torch.Tensor], exit_idx: int):
        """Prefill through exit ``exit_idx``: logits for the last position
        ``[B, 1, V_padded]`` + the per-segment caches (sized to the
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

    # -- training ----------------------------------------------------------

    def train_loss(self, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Joint early-exit LM loss (the reference's ``train_loss``): the
        cross-entropy of every exit's float32 logits against
        ``batch["labels"]`` (under ``batch["mask"]`` where given), weighted
        by ``cfg.exit_weights_`` normalised to 1, plus the MoE aux loss
        where the family routes. Returns (loss, metrics): ``loss``,
        ``nll_final``, ``nll_exit{i}`` and, for the dense, MoE and Jamba
        families, ``moe_aux``. Run it on the model's own parameters, or on
        others through ``torch.func.functional_call`` (the trainer's
        way)."""
        cfg = self.cfg
        hs, aux = self._train_trunk(batch)
        labels, mask = batch["labels"], batch.get("mask")
        per_exit = [cross_entropy(self._head(h, e), labels, mask)
                    for e, h in enumerate(hs)]
        loss = weighted_exit_loss(per_exit, cfg.exit_weights_)
        metrics = {"nll_final": per_exit[-1]}
        if aux is not None:
            loss = loss + aux
            metrics["moe_aux"] = aux
        metrics["loss"] = loss
        metrics.update({f"nll_exit{i}": l for i, l in enumerate(per_exit)})
        return loss, metrics

    def _check_cache(self, cache: dict, n_segs: int, exit_idx: int) -> None:
        if len(cache["segments"]) < n_segs:
            raise ValueError(f"the cache holds {len(cache['segments'])} "
                             f"segments, exit {exit_idx} runs {n_segs}")


class DecoderLM(EarlyExitLM):
    """Early-exit decoder LM, dense and MoE families (GQA or MLA)."""

    def __init__(self, cfg: LMConfig,
                 generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None):
        if cfg.family not in ("dense", "moe"):
            raise ValueError(f"DecoderLM serves the dense and moe families, "
                             f"not {cfg.family!r}")
        super().__init__(cfg, generator, device)
        self._draw_embedding()
        self.segments = nn.ModuleList(
            nn.ModuleList(Block(cfg, self._generator, kind)
                          for _ in range(end - start))
            for kind, start, end in cfg.segments())
        self._draw_unembedding()

    def _embed(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        if "embeds" in batch:  # modality frontend stub output (vlm/audio)
            return batch["embeds"].to(self.cfg.dtype)
        return self.embed[batch["tokens"]]

    def _run_segment(self, seg: int, h: torch.Tensor, make_cache: bool,
                     caches: Optional[dict] = None
                     ) -> Tuple[torch.Tensor, Optional[dict]]:
        """Run one segment's blocks in order. With ``make_cache`` the
        per-layer caches come back stacked on a leading layers axis, as the
        reference's scan stacks them. With ``caches`` (decode), layer ``l``
        gets the views ``[l]`` of the stacked ``[n, B, Smax, ...]`` /
        ``[n, B]`` cache, so its in-place writes land in the stack; the
        segment's buffers come back as those same tensors, with the
        advanced lengths stacked."""
        blocks = self.segments[seg]
        if caches is not None and caches["len"].shape[0] != len(blocks):
            raise ValueError(f"segment {seg} cache stacks "
                             f"{caches['len'].shape[0]} layers, the model "
                             f"{len(blocks)}")
        new_caches = []
        for layer, blk in enumerate(blocks):
            h, cache, _ = _block_apply(
                blk, h, self.cfg, make_cache,
                None if caches is None else layer_cache(caches, layer))
            new_caches.append(cache)
        if caches is None and not make_cache:
            return h, None
        return h, stack_caches(new_caches, caches)

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

    def _train_block(self, blk: Block, h: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        h, _, aux = _block_apply(blk, h, self.cfg, make_cache=False)
        return h, aux

    def _train_trunk(self, batch: Dict[str, torch.Tensor]):
        """Every segment (blocks under ``remat_call``); returns (h at each
        exit, the MoE aux summed per segment, then over segments, as the
        reference's scans sum it)."""
        cfg = self.cfg
        h = self._embed(batch)
        exits = set(cfg.exits)
        zero = torch.zeros((), dtype=torch.float32, device=h.device)
        hs, aux_total = [], zero
        for i, (_, _, end) in enumerate(cfg.segments()):
            seg_aux = zero
            for blk in self.segments[i]:
                h, aux = remat_call(self._train_block, cfg.remat, blk, h)
                seg_aux = seg_aux + aux
            aux_total = aux_total + seg_aux
            if end in exits:
                hs.append(h)
        return hs, aux_total

    def decode_step(self, token: torch.Tensor, cache: dict, exit_idx: int
                    ) -> Tuple[torch.Tensor, dict]:
        """One decode step through exit ``exit_idx``: token ``[B, 1]``
        (or ``[B, 1, D]`` embeds) against ``cache = {"segments": [stacked
        per segment]}`` from :meth:`init_cache` (lengths live inside the
        per-layer caches). Returns (float32 logits ``[B, 1, V_padded]``,
        the new cache).

        The step's k/v (MLA: latent and rope key) are written into the
        cache's tensors in place; the returned cache holds those same
        tensors and new lengths (the reference returns a new tree and
        donates the old one under ``jit``)."""
        cfg = self.cfg
        batch = {"embeds": token} if token.ndim == 3 else {"tokens": token}
        h = self._embed(batch)
        n_segs = cfg.exit_segment_index(exit_idx)
        self._check_cache(cache, n_segs, exit_idx)
        new_caches = []
        for i in range(n_segs):
            h, seg_cache = self._run_segment(i, h, False,
                                             cache["segments"][i])
            new_caches.append(seg_cache)
        return self._head(h, exit_idx), {"segments": new_caches}

    def init_cache(self, batch_size: int, max_len: int, exit_idx: int,
                   dtype: Optional[torch.dtype] = None) -> dict:
        """Zero-filled decode cache on the model's device, per segment
        through exit ``exit_idx``, the reference's shapes: k and v ``[n, B,
        max_len, K, Dh]`` (MLA: c_kv ``[n, B, max_len, d_c]`` and k_pe
        ``[n, B, max_len, r]``) in ``dtype`` (default the model's) and
        ``len`` int32 ``[n, B]``."""
        cfg = self.cfg
        dtype = dtype or cfg.dtype
        device = self.embed.device
        caches = []
        for _, start, end in cfg.segments()[:cfg.exit_segment_index(
                exit_idx)]:
            n = end - start
            if cfg.mla:
                shapes = {"c_kv": (n, batch_size, max_len, cfg.kv_lora_rank),
                          "k_pe": (n, batch_size, max_len,
                                   cfg.qk_rope_head_dim)}
            else:
                kv = (n, batch_size, max_len, cfg.num_kv_heads,
                      cfg.head_dim_)
                shapes = {"k": kv, "v": kv}
            cache = {key: torch.zeros(shape, dtype=dtype, device=device)
                     for key, shape in shapes.items()}
            cache["len"] = torch.zeros((n, batch_size), dtype=torch.int32,
                                       device=device)
            caches.append(cache)
        return {"segments": caches}
