"""qwen3-8b [dense]: 36L d_model=4096 32H (GQA kv=8) d_ff=12288 vocab=151936
— qk_norm, GQA. [hf:Qwen/Qwen3-8B; hf]"""

import torch

from repro_torch.models.transformer import LMConfig

FULL = LMConfig(
    arch_id="qwen3-8b",
    family="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=12288,
    vocab_size=151936,
    exits=(9, 18, 27, 36),
    qk_norm=True,
    rope_theta=1_000_000.0,
    dtype=torch.bfloat16,
)

SMOKE = LMConfig(
    arch_id="qwen3-8b-smoke",
    family="dense",
    num_layers=4,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    exits=(1, 2, 3, 4),
    qk_norm=True,
    dtype=torch.float32,
)
