"""seamless-m4t-large-v2 [audio]: enc-dec, 24L(+24 enc) d_model=1024 16H
(kv=16) d_ff=8192 vocab=256206 — multimodal. [arXiv:2308.11596; hf]

The audio frontend is a STUB per the assignment spec: ``input_specs()``
provides precomputed frame embeddings to the encoder. Early exits attach to
the decoder only; the encoder always runs fully (every exit's
cross-attention reads the full encoder output).
"""

import torch

from repro_torch.models.transformer import LMConfig

FULL = LMConfig(
    arch_id="seamless-m4t-large-v2",
    family="encdec",
    num_layers=24,                 # decoder layers (exit-bearing)
    num_encoder_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256206,
    exits=(6, 12, 18, 24),
    frontend="audio",
    frontend_seq=1024,
    dtype=torch.bfloat16,
)

SMOKE = LMConfig(
    arch_id="seamless-m4t-large-v2-smoke",
    family="encdec",
    num_layers=4,
    num_encoder_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    exits=(1, 2, 3, 4),
    frontend="audio",
    frontend_seq=16,
    dtype=torch.float32,
)
