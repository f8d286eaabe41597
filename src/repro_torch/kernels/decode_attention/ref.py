"""Plain PyTorch version of the decode-attention kernel
(``csrc/decode_attention.cu``): the reference's oracle
``decode_attention_ref`` (``src/repro/kernels/decode_attention/ref.py``).

Float32 softmax with scale 1/sqrt(D), positions at or past a row's length
masked to -1e30, the probabilities cast to q's dtype before the value
product, as the oracle does. The inputs may be strided views (the model's
``[B, Smax, K, D]`` cache transposed to ``[B, K, Smax, D]``).

At ``length == 0`` every position is masked and this version, like the
oracle, returns the mean of v; the CUDA kernel and the reference's Pallas
kernel return 0. The model always passes lengths >= 1.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           lengths: torch.Tensor) -> torch.Tensor:
    """q ``[B, H, D]``; k, v ``[B, K, S, D]``; lengths ``[B]`` (the valid
    cache prefix of each row) -> ``[B, H, D]`` in q's dtype."""
    b, h, d = q.shape
    kh, s = k.shape[1], k.shape[2]
    qg = q.reshape(b, kh, h // kh, d)
    scores = torch.einsum("bkgd,bksd->bkgs", qg, k).to(torch.float32)
    scores = scores * (1.0 / torch.sqrt(torch.tensor(float(d)))).item()
    valid = (torch.arange(s, device=q.device)[None, :]
             < lengths.to(q.device)[:, None])
    scores = scores.masked_fill(~valid[:, None, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgs,bksd->bkgd", probs, v)
    return out.reshape(b, h, d)
