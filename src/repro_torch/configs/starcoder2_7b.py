"""starcoder2-7b [dense]: 32L d_model=4608 36H (GQA kv=4) d_ff=18432
vocab=49152 — GQA, RoPE. [arXiv:2402.19173; hf]"""

import torch

from repro_torch.models.transformer import LMConfig

FULL = LMConfig(
    arch_id="starcoder2-7b",
    family="dense",
    num_layers=32,
    d_model=4608,
    num_heads=36,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18432,
    vocab_size=49152,
    exits=(8, 16, 24, 32),
    rope_theta=100_000.0,
    mlp_gated=False,               # starcoder2: plain GeLU FFN
    dtype=torch.bfloat16,
)

SMOKE = LMConfig(
    arch_id="starcoder2-7b-smoke",
    family="dense",
    num_layers=4,
    d_model=72,
    num_heads=6,
    num_kv_heads=2,
    head_dim=16,
    d_ff=160,
    vocab_size=256,
    exits=(1, 2, 3, 4),
    mlp_gated=False,
    dtype=torch.float32,
)
