"""Feed-forward layers (reference ``src/repro/models/moe.py``): the dense
MLP and the fine-grained Mixture-of-Experts.

The MoE keeps the reference's dispatch/combine einsum form: tokens are
grouped, each group assigns its (token, slot) pairs to per-expert capacity
slots through one-hot dispatch tensors in token order, every expert's FFN
runs as one batched product over its capacity slots, and the results are
combined with the routing weights. Shared experts run beside the routed
top-k; the router is softmax (DeepSeek-MoE) or sigmoid with normalised
top-k weights (DeepSeek-V3); the Switch load-balance loss comes back with
the output. All of it is plain torch: no kernel of the port takes these
shapes, and the reference leaves them to XLA.

One deliberate difference: the top-k is a stable descending sort cut at k,
so that equal scores go to the lower expert index, as ``jax.lax.top_k``
orders them; ``torch.topk`` makes no such promise on the card, and
bfloat16 router scores tie often.

``record_routing()`` is a record-only hook: inside it every routing call
appends its expert indices, the k-th and (k+1)-th scores and which
(token, slot) pairs found a capacity slot, on the device and without a
host sync, so a caller can compare two runs' routes or count ties.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import checks
from repro_torch.models.common import make_param, make_stacked_param, swiglu


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    d_model: int
    d_ff: int
    gated: bool = True             # SwiGLU (llama family) vs GeLU


def init_mlp(generator: torch.Generator, cfg: MLPConfig,
             dtype: torch.dtype = torch.float32
             ) -> Dict[str, torch.nn.Parameter]:
    d, f = cfg.d_model, cfg.d_ff
    p = {
        "w_up": make_param((d, f), generator, dtype=dtype,
                           axes=("embed", "mlp")),
        "w_down": make_param((f, d), generator, dtype=dtype,
                             axes=("mlp", "embed")),
    }
    if cfg.gated:
        p["w_gate"] = make_param((d, f), generator, dtype=dtype,
                                 axes=("embed", "mlp"))
    return p


def mlp(params, x: torch.Tensor, cfg: MLPConfig) -> torch.Tensor:
    if cfg.gated:
        h = swiglu(x @ params["w_gate"], x @ params["w_up"])
    else:
        # jax.nn.gelu defaults to the tanh approximation; F.gelu does not
        h = F.gelu(x @ params["w_up"], approximate="tanh")
    return h @ params["w_down"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff_expert: int               # per-expert hidden (fine-grained: small)
    num_experts: int               # routed experts
    top_k: int
    num_shared: int = 0            # always-active shared experts
    d_ff_shared: Optional[int] = None  # defaults to num_shared * d_ff_expert
    capacity_factor: float = 1.25
    router_type: str = "softmax"   # "softmax" (dsmoe) | "sigmoid" (dsv3)
    aux_loss_weight: float = 0.001
    group_size: int = 1024         # tokens per dispatch group

    @property
    def shared_ff(self) -> int:
        return self.d_ff_shared or self.num_shared * self.d_ff_expert


def init_moe(generator: torch.Generator, cfg: MoEConfig,
             dtype: torch.dtype = torch.float32) -> dict:
    """The reference's tree: ``router``, the stacked experts ``we_gate``,
    ``we_up`` ``[E, D, F]`` and ``we_down`` ``[E, F, D]`` (drawn one expert
    at a time), and ``shared`` when there are shared experts."""
    d, f, e = cfg.d_model, cfg.d_ff_expert, cfg.num_experts
    p = {
        "router": make_param((d, e), generator, scale=0.02, dtype=dtype,
                             axes=("embed", "expert")),
        # stacked expert FFNs: the leading `expert` axis shards over EP
        "we_gate": make_stacked_param((e, d, f), generator, dtype=dtype,
                                      axes=("expert", "embed", "mlp")),
        "we_up": make_stacked_param((e, d, f), generator, dtype=dtype,
                                    axes=("expert", "embed", "mlp")),
        "we_down": make_stacked_param((e, f, d), generator, dtype=dtype,
                                      axes=("expert", "mlp", "embed")),
    }
    if cfg.num_shared > 0:
        fs = cfg.shared_ff
        p["shared"] = {
            "w_gate": make_param((d, fs), generator, dtype=dtype,
                                 axes=("embed", "mlp")),
            "w_up": make_param((d, fs), generator, dtype=dtype,
                               axes=("embed", "mlp")),
            "w_down": make_param((fs, d), generator, dtype=dtype,
                                 axes=("mlp", "embed")),
        }
    return p


_ROUTING_LOG: Optional[List[dict]] = None


@contextlib.contextmanager
def record_routing() -> Iterator[List[dict]]:
    """Collect every routing call made inside the block: a list of
    ``{"idx" [T, k] int64, "kth" [T], "next" [T] (the k-th and (k+1)-th
    scores, float32; ``next`` is -inf when k == E), "kept" [T, k] bool}``
    per MoE call, tokens in order (group padding dropped)."""
    global _ROUTING_LOG
    outer, _ROUTING_LOG = _ROUTING_LOG, []
    try:
        yield _ROUTING_LOG
    finally:
        _ROUTING_LOG = outer


def stable_top_k(scores: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest scores along the last axis, equal
    scores in index order (``jax.lax.top_k``'s order), and the (k+1)-th
    score (-inf when there is none)."""
    values, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    nxt = (values[..., k] if scores.shape[-1] > k
           else torch.full_like(values[..., 0], float("-inf")))
    return values[..., :k], idx[..., :k], nxt


def _routing(params, x3d: torch.Tensor, cfg: MoEConfig):
    """Grouped token->expert assignment: x3d ``[G, Tg, D]`` -> (weights
    ``[G, Tg, k]`` in x's dtype, idx ``[G, Tg, k]``, aux scalar, and the
    k-th and (k+1)-th scores ``[G, Tg]`` before any normalisation)."""
    logits = (x3d @ params["router"]).to(torch.float32)       # [G, Tg, E]
    probs = torch.softmax(logits, dim=-1)
    sigmoid = cfg.router_type == "sigmoid"
    scores = torch.sigmoid(logits) if sigmoid else probs
    top, idx, nxt = stable_top_k(scores, cfg.top_k)
    w = top / torch.clamp(top.sum(-1, keepdim=True), min=1e-9) if sigmoid \
        else top
    # Switch-style load-balance loss over the full softmax distribution
    me = probs.mean(dim=(0, 1))                               # [E]
    ce = F.one_hot(idx[..., 0], cfg.num_experts).to(torch.float32).mean(
        dim=(0, 1))
    aux = cfg.num_experts * torch.sum(me * ce) * cfg.aux_loss_weight
    return w.to(x3d.dtype), idx, aux, top[..., -1], nxt


def _experts(x3d, dispatch, combine, we_gate, we_up, we_down,
             reduce=None) -> torch.Tensor:
    """The routed experts: x3d ``[G, Tg, D]`` into the experts' buffers by
    ``dispatch`` ``[G, Tg, E, C]``, each expert's SwiGLU, and back by
    ``combine`` -> ``[G, Tg, D]``. ``reduce(stage, t)`` is applied to the
    buffers (stage "buffers") and to the gate and up products ("products")
    before the SwiGLU: a partition that splits a contraction sums its
    partial products with it."""
    xe = torch.einsum("gtd,gtec->gecd", x3d, dispatch)       # [G, E, C, D]
    if reduce is not None:
        xe = reduce("buffers", xe)
    gate = torch.einsum("gecd,edf->gecf", xe, we_gate)
    up = torch.einsum("gecd,edf->gecf", xe, we_up)
    if reduce is not None:
        gate, up = reduce("products", gate), reduce("products", up)
    ye = torch.einsum("gecf,efd->gecd", swiglu(gate, up), we_down)
    return torch.einsum("gecd,gtec->gtd", ye, combine)


def moe(params, x: torch.Tensor, cfg: MoEConfig
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE forward. x ``[B, S, D]`` (or ``[T, D]``); returns (out, aux).

    Tokens go in groups of ``cfg.group_size`` (the last one zero-padded),
    with per-group, per-expert capacity ``C = max(int(Tg * k / E *
    capacity_factor), 1)``; a (token, slot) pair past its expert's capacity
    in its group is dropped (combine weight 0), the reference's Switch
    semantics.
    """
    orig_shape = x.shape
    d = cfg.d_model
    x2d = x.reshape(-1, d)
    t = x2d.shape[0]
    e, k = cfg.num_experts, cfg.top_k
    tg = min(cfg.group_size, t)
    g = -(-t // tg)
    pad = g * tg - t
    if pad:
        x2d = torch.cat([x2d, x2d.new_zeros((pad, d))])
    x3d = x2d.reshape(g, tg, d)

    weights, idx, aux, kth, nxt = _routing(params, x3d, cfg)

    cap = max(int(tg * k / e * cfg.capacity_factor), 1)
    # each (token, slot)'s place in its expert's per-group buffer: the
    # count of earlier assignments to that expert in the group, token-major
    expert_onehot = F.one_hot(idx, e).to(torch.int32)         # [G, Tg, k, E]
    flat = expert_onehot.reshape(g, tg * k, e)
    pos = (torch.cumsum(flat, dim=1) * flat - 1).reshape(g, tg, k, e)

    dispatch = x2d.new_zeros((g, tg, e, cap))
    combine = x2d.new_zeros((g, tg, e, cap))
    kept = []
    for slot in range(k):
        p_s = (pos[:, :, slot, :] * expert_onehot[:, :, slot, :]).sum(-1)
        ok = (p_s >= 0) & (p_s < cap)                         # [G, Tg]
        kept.append(ok)
        oh = (F.one_hot(p_s.clamp(0, cap - 1).long(), cap).to(x2d.dtype)
              * ok[..., None].to(x2d.dtype))                  # [G, Tg, C]
        eh = expert_onehot[:, :, slot, :].to(x2d.dtype)       # [G, Tg, E]
        both = eh[..., None] * oh[..., None, :]
        dispatch = dispatch + both
        combine = combine + both * weights[:, :, slot, None, None]

    if _ROUTING_LOG is not None:
        _ROUTING_LOG.append({
            "idx": idx.reshape(g * tg, k)[:t],
            "kth": kth.reshape(g * tg)[:t],
            "next": nxt.reshape(g * tg)[:t],
            "kept": torch.stack(kept, -1).reshape(g * tg, k)[:t]})

    out = checks.partitioned(
        "moe_experts", _experts, x3d, dispatch, combine, params["we_gate"],
        params["we_up"], params["we_down"]).reshape(g * tg, d)
    if pad:
        out = out[:t]
    if cfg.num_shared > 0:
        sh = params["shared"]
        x_real = x2d[:t]
        out = out + swiglu(x_real @ sh["w_gate"],
                           x_real @ sh["w_up"]) @ sh["w_down"]
    return out.reshape(orig_shape), aux
