"""Plain float32 reference of the served early-exit LMs.

Two families, written from their published descriptions as the
configuration file states them:

* the dense pre-norm GQA decoder (Phi-4-mini, StarCoder2): RMSNorm,
  rotary positions on q and k, causal grouped-query attention, then a
  SwiGLU MLP (``mlp_gated``) or a tanh-GeLU MLP;
* the encoder-decoder (SeamlessM4T-v2's text decoder over a speech
  encoder): a bidirectional encoder over frame embeddings with rotary
  positions and a final norm, then decoder layers of causal
  self-attention, cross-attention over the encoder output (no positions,
  no mask) and the SwiGLU MLP.

An early exit ``e`` runs the first ``exits[e]`` decoder layers, then the
exit's RMSNorm and the unembedding on the last position (the input
embedding's transpose where the configuration ties them).

Conventions the configurations state: rotary positions rotate the pairs
``(x[2i], x[2i+1])`` by ``pos * theta ** (-2i / head_dim)`` over the whole
head (full RoPE); attention scales by ``1 / sqrt(head_dim)``; kv head
``j`` serves query heads ``j * G .. j * G + G - 1``.

Weights come as a dict by parameter path (``segments.<i>.<j>.attn.wq``,
``encoder.<l>.ffn.w_up``, ``embed``, ``lm_head`` unless the embeddings
are tied, ...), the layout in
which the benchmark draws them; a layer is upcast to float32 when it is
used, so the reference runs a layer at a time beside the served weights.
Products run in float32 with TF32 off. With ``fp8=True`` every product's
operands are rounded to float8 e4m3 with one scale per tensor first: the
precision below the configurations' bfloat16, the benchmark's control.

A model of another family is referred to its file under
``bench/families/``. Nothing here imports the program.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

import families

F8_MAX = 448.0  # largest float8 e4m3 value


def strict_float32() -> None:
    """Products in full float32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fake_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale (amax / 448), back in
    float32."""
    amax = x.abs().amax().clamp(min=1e-12)
    scale = amax / F8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class Arith:
    """The reference's products, in float32 or through float8."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def q(self, x: torch.Tensor) -> torch.Tensor:
        return fake_fp8(x) if self.fp8 else x

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return self.q(x) @ w  # weights are rounded once, at upcast


def rms(x: torch.Tensor, gain: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * gain


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate ``x [R, S, H, D]`` at positions 0..S-1."""
    s, d = x.shape[1], x.shape[-1]
    inv = theta ** (-torch.arange(0, d, 2, dtype=torch.float64,
                                  device=x.device) / d)
    ang = torch.arange(s, dtype=torch.float64, device=x.device)[:, None] * inv
    cos = ang.cos().to(torch.float32)[:, None, :]
    sin = ang.sin().to(torch.float32)[:, None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    out = torch.empty_like(x)
    out[..., 0::2] = x1 * cos - x2 * sin
    out[..., 1::2] = x1 * sin + x2 * cos
    return out


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
           ar: Arith) -> torch.Tensor:
    """q ``[R, Sq, H, D]``, k and v ``[R, Skv, K, D]`` -> ``[R, Sq, H*D]``."""
    r, sq, h, d = q.shape
    kh = k.shape[2]
    g = h // kh
    qg = ar.q(q).reshape(r, sq, kh, g, d)
    scores = torch.einsum("rqkgd,rskd->rkgqs", qg, ar.q(k)) / math.sqrt(d)
    if causal:
        skv = k.shape[1]
        keep = (torch.arange(skv, device=q.device)[None, :]
                <= torch.arange(sq, device=q.device)[:, None])
        scores = scores.masked_fill(~keep, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("rkgqs,rskd->rqkgd", ar.q(probs), ar.q(v))
    return out.reshape(r, sq, h * d)


def _upcast(weights: Dict[str, torch.Tensor], prefix: str,
            ar: Arith) -> Dict[str, torch.Tensor]:
    """One layer's weights in float32 (float8-rounded matrices with
    ``ar.fp8``), keyed without ``prefix``."""
    out = {}
    for name, w in weights.items():
        if name.startswith(prefix):
            w32 = w.to(torch.float32)
            out[name[len(prefix):]] = (fake_fp8(w32) if ar.fp8 and w.ndim == 2
                                       else w32)
    return out


def _self_attention(p, x, lm, ar, causal, prefix="attn."):
    r, s, _ = x.shape
    h, kh, d = lm["num_heads"], lm["num_kv_heads"], _head_dim(lm)
    q = ar.mm(x, p[prefix + "wq"]).reshape(r, s, h, d)
    k = ar.mm(x, p[prefix + "wk"]).reshape(r, s, kh, d)
    v = ar.mm(x, p[prefix + "wv"]).reshape(r, s, kh, d)
    q, k = rope(q, lm["rope_theta"]), rope(k, lm["rope_theta"])
    return ar.mm(attend(q, k, v, causal, ar), p[prefix + "wo"])


def _mlp(p, x, lm, ar):
    if lm.get("mlp_gated", True):
        hidden = F.silu(ar.mm(x, p["ffn.w_gate"])) * ar.mm(x, p["ffn.w_up"])
    else:
        hidden = F.gelu(ar.mm(x, p["ffn.w_up"]), approximate="tanh")
    return ar.mm(hidden, p["ffn.w_down"])


def _head_dim(lm) -> int:
    return lm.get("head_dim") or lm["d_model"] // lm["num_heads"]


def layer_prefix(lm: dict, layer: int) -> str:
    """Path prefix of decoder layer ``layer``: its exit segment and its
    place there."""
    bounds = [0] + list(lm["exits"])
    for seg, (a, b) in enumerate(zip(bounds, bounds[1:])):
        if a <= layer < b:
            return f"segments.{seg}.{layer - a}."
    raise ValueError(f"layer {layer} is past the last exit {bounds[-1]}")


def _blocks(n: int, rows: int):
    for a in range(0, n, rows):
        yield slice(a, min(a + rows, n))


def encode(weights, lm: dict, src: torch.Tensor, ar: Arith,
           rows: int = 4) -> torch.Tensor:
    """The bidirectional encoder over frame embeddings ``[R, S_src, D]``."""
    eps = lm.get("norm_eps", 1e-6)
    h = src.to(torch.float32)
    for layer in range(lm["num_encoder_layers"]):
        p = _upcast(weights, f"encoder.{layer}.", ar)
        for blk in _blocks(h.shape[0], rows):
            x = h[blk]
            x = x + _self_attention(p, rms(x, p["norm1"], eps), lm, ar,
                                    causal=False)
            h[blk] = x + _mlp(p, rms(x, p["norm2"], eps), lm, ar)
    return rms(h, weights["enc_norm"].to(torch.float32), eps)


def exit_logits(weights: Dict[str, torch.Tensor], lm: dict,
                tokens: torch.Tensor, exits: Sequence[int],
                src: torch.Tensor = None, fp8: bool = False,
                rows: int = 8) -> List[torch.Tensor]:
    """The last position's float32 logits ``[V]`` of each row of ``tokens
    [R, S]`` (with frame embeddings ``src [R, S_src, D]`` for the
    encoder-decoder) at that row's exit ``exits[r]``, run a layer at a time
    over blocks of ``rows`` rows."""
    if lm["family"] not in families.BUILT_IN:
        return families.module(lm["family"]).exit_logits(
            weights, lm, tokens, exits, src=src, fp8=fp8)
    ar = Arith(fp8)
    eps = lm.get("norm_eps", 1e-6)
    exit_layers = list(lm["exits"])
    want = torch.as_tensor(list(exits), device=tokens.device)
    n_rows = tokens.shape[0]
    h = weights["embed"][tokens].to(torch.float32)
    enc = None
    if lm["family"] == "encdec":
        enc = encode(weights, lm, src, ar)
    head = _unembedding(weights, lm, ar)
    out: List[torch.Tensor] = [None] * n_rows
    last = exit_layers[int(want.max())]
    for layer in range(last):
        alive = torch.nonzero(want >= _exit_of(exit_layers, layer)
                              ).flatten().tolist()
        p = _upcast(weights, layer_prefix(lm, layer), ar)
        for blk in _blocks(len(alive), rows):
            idx = alive[blk]
            x = h[idx]
            x = x + _self_attention(p, rms(x, p["norm1"], eps), lm, ar,
                                    causal=True)
            if enc is not None:
                x = x + _cross_attention(p, rms(x, p["norm2"], eps), enc[idx],
                                         lm, ar)
                x = x + _mlp(p, rms(x, p["norm3"], eps), lm, ar)
            else:
                x = x + _mlp(p, rms(x, p["norm2"], eps), lm, ar)
            h[idx] = x
        if layer + 1 in exit_layers:
            e = exit_layers.index(layer + 1)
            gain = weights[f"exit_norms.{e}"].to(torch.float32)
            for r in torch.nonzero(want == e).flatten().tolist():
                last_h = rms(h[r, -1], gain, eps)
                out[r] = ar.mm(last_h[None], head)[0]
    return out


def _unembedding(weights: Dict[str, torch.Tensor], lm: dict,
                 ar: Arith) -> torch.Tensor:
    """The exits' unembedding ``[D, V]`` in float32 (float8-rounded with
    ``ar.fp8``): the input embedding's transpose where the configuration
    ties them, else ``lm_head``."""
    v = lm["vocab_size"]
    if lm.get("tie_embeddings", False):
        w = weights["embed"][:v].T
    else:
        w = weights["lm_head"][:, :v]
    w = w.to(torch.float32)
    return fake_fp8(w) if ar.fp8 else w


def _exit_of(exit_layers: Sequence[int], layer: int) -> int:
    """The shallowest exit that runs ``layer``."""
    for e, n in enumerate(exit_layers):
        if layer < n:
            return e
    raise ValueError(f"layer {layer} is past the last exit")


def _cross_attention(p, x, enc, lm, ar):
    r, s, _ = x.shape
    h, kh, d = lm["num_heads"], lm["num_kv_heads"], _head_dim(lm)
    q = ar.mm(x, p["xattn.wq"]).reshape(r, s, h, d)
    k = ar.mm(enc, p["xattn.wk"]).reshape(r, enc.shape[1], kh, d)
    v = ar.mm(enc, p["xattn.wv"]).reshape(r, enc.shape[1], kh, d)
    return ar.mm(attend(q, k, v, False, ar), p["xattn.wo"])
