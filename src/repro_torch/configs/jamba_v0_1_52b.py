"""jamba-v0.1-52b [hybrid]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336,
Mamba+attention 1:7 interleave, MoE 16e top-2 every other layer.
[arXiv:2403.19887; hf]

Only 4 of 32 layers hold a KV cache -> runs long_500k (DESIGN.md
§Arch-applicability). Exits align to superblock (8-layer) boundaries.
"""

import torch

from repro_torch.models.transformer import LMConfig

FULL = LMConfig(
    arch_id="jamba-v0.1-52b",
    family="jamba",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    exits=(8, 16, 24, 32),
    attn_period=8,
    attn_offset=3,                 # one attention layer per 8 (1:7)
    moe_period=2,                  # MoE every other layer
    num_experts=16,
    top_k=2,
    d_ff_expert=14336,
    moe_router="softmax",
    mamba_d_state=16,
    mamba_d_conv=4,
    mamba_expand=2,
    rope_theta=10_000.0,
    dtype=torch.bfloat16,
    remat="dots",
)

SMOKE = LMConfig(
    arch_id="jamba-v0.1-52b-smoke",
    family="jamba",
    num_layers=8,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    exits=(4, 8),
    attn_period=4,
    attn_offset=3,
    moe_period=2,
    num_experts=4,
    top_k=2,
    d_ff_expert=64,
    moe_group_size=16,
    mamba_d_state=8,
    mamba_d_conv=3,
    mamba_expand=2,
    dtype=torch.float32,
)
