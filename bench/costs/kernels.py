"""Bytes and operations of one call of the port's kernels, from its shape.

Each input is read once and each output written once, whatever the kernel
reads again; causal attention is counted at half the square (the work its
inputs need). Copied from the port's smoke script (``_lm_kernel_cost``).
"""

from __future__ import annotations

from typing import List, Tuple

import families
from costs.peaks import matrix_rate

# (kernel, shape): flash attention (B, H, K, S_q, S_kv, D, causal); the
# exit head (T, D, V)
Call = Tuple[str, tuple]


def call_cost(kernel: str, shape: tuple, dtype_bytes: int
              ) -> Tuple[float, float, float]:
    """(bytes, operations, peak rate) of one call."""
    el = dtype_bytes
    if kernel == "flash_attention":
        b, h, kh, sq, skv, d, causal = shape
        nbytes = (2 * b * h * sq * d + 2 * b * kh * skv * d) * el
        ops = 4.0 * b * h * sq * skv * d / (2 if causal else 1)
        return nbytes, ops, matrix_rate(el)
    if kernel == "exit_head":
        t, d, v = shape
        # h, the gain and W read; token, max and lse (4 bytes each) written
        return (t * d + d + d * v) * el + t * 12, 2.0 * t * d * v, \
            matrix_rate(el)
    raise ValueError(f"no cost for kernel {kernel!r}")


def quantum_calls(lm: dict, exit_idx: int, batch: int,
                  prompt_len: int) -> List[Call]:
    """The flash-attention and exit-head calls of one served quantum, in
    launch order: the encoder's (bidirectional, over the frames) first for
    the encoder-decoder, then one causal call per decoder layer through
    the exit, then the exit head on the last position."""
    if lm["family"] not in families.BUILT_IN:
        return families.module(lm["family"]).quantum_calls(
            lm, exit_idx, batch, prompt_len)
    h, kh = lm["num_heads"], lm["num_kv_heads"]
    d = lm.get("head_dim") or lm["d_model"] // h
    layers = lm["exits"][exit_idx]
    calls: List[Call] = []
    if lm["family"] == "encdec":
        src = lm["frontend_seq"]
        calls += [("flash_attention", (batch, h, kh, src, src, d, False))
                  ] * lm["num_encoder_layers"]
    calls += [("flash_attention",
               (batch, h, kh, prompt_len, prompt_len, d, True))] * layers
    calls.append(("exit_head", (batch, lm["d_model"], lm["vocab_size"])))
    return calls
