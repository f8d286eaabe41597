"""Model operations of one served quantum, from shapes: the products of
the trunk through the exit and of the exit head on the last position
(2 per multiply-add). Elementwise work is not counted. Causal attention
counts ``causal`` of the square (half by default: the work it needs)."""

from __future__ import annotations

import families


def _attention(b, h, sq, skv, d, frac):
    return 4.0 * b * h * sq * skv * d * frac


def _projections(b, s, dm, h, kh, d):
    return 2.0 * b * s * dm * (h * d + 2 * kh * d) + 2.0 * b * s * h * d * dm


def _mlp(b, s, dm, ff, gated):
    return 2.0 * b * s * dm * ff * (3 if gated else 2)


def quantum_flops(lm: dict, exit_idx: int, batch: int, prompt_len: int,
                  causal: float = 0.5) -> float:
    if lm["family"] not in families.BUILT_IN:
        return families.module(lm["family"]).quantum_flops(
            lm, exit_idx, batch, prompt_len)
    b, s = batch, prompt_len
    dm, h, kh, ff = lm["d_model"], lm["num_heads"], lm["num_kv_heads"], \
        lm["d_ff"]
    d = lm.get("head_dim") or dm // h
    gated = lm.get("mlp_gated", True)
    layers = lm["exits"][exit_idx]
    per_layer = (_projections(b, s, dm, h, kh, d)
                 + _attention(b, h, s, s, d, causal) + _mlp(b, s, dm, ff, gated))
    total = layers * per_layer
    if lm["family"] == "encdec":
        src = lm["frontend_seq"]
        enc = (_projections(b, src, dm, h, kh, d)
               + _attention(b, h, src, src, d, 1.0) + _mlp(b, src, dm, ff, gated))
        cross = (2.0 * b * s * dm * h * d + 2.0 * b * src * dm * 2 * kh * d
                 + _attention(b, h, s, src, d, 1.0) + 2.0 * b * s * h * d * dm)
        total += lm["num_encoder_layers"] * enc + layers * cross
    return total + 2.0 * b * dm * lm["vocab_size"]
