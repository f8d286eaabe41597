"""llava-next-mistral-7b [vlm]: Mistral-7B backbone — 32L d_model=4096 32H
(GQA kv=8) d_ff=14336 vocab=32000 — anyres tiling.
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]

Per the assignment spec, the modality frontend is a STUB: ``input_specs()``
provides precomputed patch embeddings (anyres tiling is absorbed into the
stub's sequence length). The transformer backbone is what this config
exercises.
"""

import torch

from repro_torch.models.transformer import LMConfig

FULL = LMConfig(
    arch_id="llava-next-mistral-7b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    exits=(8, 16, 24, 32),
    rope_theta=1_000_000.0,
    dtype=torch.bfloat16,
    frontend="vision",
    frontend_seq=2880,             # anyres: up to 5 tiles x 576 patches
)

SMOKE = LMConfig(
    arch_id="llava-next-mistral-7b-smoke",
    family="dense",
    num_layers=4,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    exits=(1, 2, 3, 4),
    dtype=torch.float32,
    frontend="vision",
    frontend_seq=16,
)
