"""deepseek-v3-671b [moe]: 61L d_model=7168 128H d_ff=2048(expert)
vocab=129280, MLA, 1 shared + 256 routed top-8 (sigmoid router), first 3
layers dense (d_ff 18432). [arXiv:2412.19437; hf]

Adaptation notes (DESIGN.md §2): MTP (multi-token prediction) is a training
add-on head, not exercised by the assigned shapes; the MLA decode cache
stores the compressed latent (512 + 64 per token) — the reason this arch's
decode_32k cell is far lighter on HBM than its head count suggests.
"""

import torch

from repro_torch.models.transformer import LMConfig

FULL = LMConfig(
    arch_id="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,
    head_dim=128,
    d_ff=18432,                    # dense prefix FFN
    vocab_size=129280,
    exits=(15, 30, 45, 61),
    num_experts=256,
    top_k=8,
    num_shared_experts=1,
    d_ff_expert=2048,
    moe_router="sigmoid",
    dense_prefix=3,
    mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    rope_theta=10_000.0,
    dtype=torch.bfloat16,
    remat="dots",                  # 671B training wants activation remat
)

SMOKE = LMConfig(
    arch_id="deepseek-v3-671b-smoke",
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
    num_shared_experts=1,
    d_ff_expert=32,
    moe_router="sigmoid",
    dense_prefix=1,
    mla=True,
    q_lora_rank=32,
    kv_lora_rank=16,
    qk_nope_head_dim=16,
    qk_rope_head_dim=8,
    v_head_dim=16,
    moe_group_size=16,
    dtype=torch.float32,
)
