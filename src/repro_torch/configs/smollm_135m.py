"""smollm-135m [dense]: 30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152
— llama-arch small, tied embeddings. [hf:HuggingFaceTB/SmolLM-135M; hf]"""

import torch

from repro_torch.models.transformer import LMConfig

FULL = LMConfig(
    arch_id="smollm-135m",
    family="dense",
    num_layers=30,
    d_model=576,
    num_heads=9,
    num_kv_heads=3,
    head_dim=64,
    d_ff=1536,
    vocab_size=49152,
    exits=(8, 15, 23, 30),
    tie_embeddings=True,
    rope_theta=10000.0,
    dtype=torch.bfloat16,
)

SMOKE = LMConfig(
    arch_id="smollm-135m-smoke",
    family="dense",
    num_layers=4,
    d_model=48,
    num_heads=3,
    num_kv_heads=1,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    exits=(1, 2, 3, 4),
    tie_embeddings=True,
    dtype=torch.float32,
)
