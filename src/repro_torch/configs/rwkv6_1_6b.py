"""rwkv6-1.6b [ssm]: 24L d_model=2048 (attention-free) d_ff=7168 vocab=65536
— Finch, data-dependent decay. [arXiv:2404.05892; unverified]

Attention-free: no KV cache exists; per-layer state is O(1) in context, so
this arch runs the long_500k shape (DESIGN.md §Arch-applicability).
"""

import torch

from repro_torch.models.transformer import LMConfig

FULL = LMConfig(
    arch_id="rwkv6-1.6b",
    family="rwkv",
    num_layers=24,
    d_model=2048,
    num_heads=32,                  # RWKV-6 head size 64
    num_kv_heads=32,
    head_dim=64,
    d_ff=7168,
    vocab_size=65536,
    exits=(6, 12, 18, 24),
    dtype=torch.bfloat16,
)

SMOKE = LMConfig(
    arch_id="rwkv6-1.6b-smoke",
    family="rwkv",
    num_layers=4,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    exits=(1, 2, 3, 4),
    dtype=torch.float32,
)
