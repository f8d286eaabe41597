"""deepseek-moe-16b [moe]: 28L d_model=2048 16H (MHA kv=16) d_ff=1408(expert)
vocab=102400, 2 shared + 64 routed top-6, fine-grained experts, first layer
dense (d_ff 10944). [arXiv:2401.06066; hf]"""

import torch

from repro_torch.models.transformer import LMConfig

FULL = LMConfig(
    arch_id="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=10944,                    # the dense first layer's FFN
    vocab_size=102400,
    exits=(7, 14, 21, 28),
    num_experts=64,
    top_k=6,
    num_shared_experts=2,
    d_ff_expert=1408,
    moe_router="softmax",
    dense_prefix=1,
    rope_theta=10_000.0,
    dtype=torch.bfloat16,
)

SMOKE = LMConfig(
    arch_id="deepseek-moe-16b-smoke",
    family="moe",
    num_layers=5,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=160,
    vocab_size=256,
    exits=(2, 3, 4, 5),
    num_experts=8,
    top_k=2,
    num_shared_experts=2,
    d_ff_expert=32,
    moe_router="softmax",
    dense_prefix=1,
    moe_group_size=16,
    dtype=torch.float32,
)
