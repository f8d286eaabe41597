"""phi4-mini-3.8b [dense]: 32L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=200064 — RoPE SwiGLU GQA. [arXiv:2412.08905; hf]

Adaptation note: phi-4-mini uses partial-rotary long-rope; we apply standard
full RoPE (DESIGN.md §2 — positional flavour does not change latency/FLOPs).
"""

import torch

from repro_torch.models.transformer import LMConfig

FULL = LMConfig(
    arch_id="phi4-mini-3.8b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=200064,
    exits=(8, 16, 24, 32),
    rope_theta=10_000.0,
    dtype=torch.bfloat16,
)

SMOKE = LMConfig(
    arch_id="phi4-mini-3.8b-smoke",
    family="dense",
    num_layers=4,
    d_model=48,
    num_heads=3,
    num_kv_heads=1,
    head_dim=16,
    d_ff=96,
    vocab_size=256,
    exits=(1, 2, 3, 4),
    dtype=torch.float32,
)
