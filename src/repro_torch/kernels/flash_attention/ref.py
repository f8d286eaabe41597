"""Plain PyTorch version of the flash-attention kernel
(``csrc/flash_attention.cu``).

``sdpa_plain`` is the reference's jnp attention (``_sdpa`` in
``src/repro/models/attention.py``) in the model's ``[B, S, H, D]`` layout;
``flash_attention_plain`` is the reference's oracle
(``kernels/flash_attention/ref.py``) in the kernel's heads-first layout.
Both keep the softmax in float32 and cast the probabilities to the input
dtype before the value product, as the reference does.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def sdpa_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               causal: bool, q_offset: int = 0,
               kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q ``[B, Sq, H, Dh]``; k, v ``[B, Skv, K, Dh]`` (GQA by kv-head
    broadcasting) -> ``[B, Sq, H, Dv]`` in q's dtype. ``q_offset`` is the
    absolute position of q[0]; ``kv_len [B]`` masks the cache tail."""
    b, sq, h, dh = q.shape
    _, skv, kh, _ = k.shape
    g = h // kh
    qg = q.reshape(b, sq, kh, g, dh)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k).to(torch.float32)
    scores = scores * (1.0 / torch.sqrt(torch.tensor(float(dh)))).item()
    if causal and sq > 1:
        qpos = torch.arange(sq, device=q.device) + q_offset
        kpos = torch.arange(skv, device=q.device)
        mask = kpos[None, :] <= qpos[:, None]
        scores = scores.masked_fill(~mask[None, None, None], NEG_INF)
    if kv_len is not None:
        valid = torch.arange(skv, device=q.device)[None, :] < kv_len[:, None]
        scores = scores.masked_fill(~valid[:, None, None, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(b, sq, h, v.shape[-1])


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True) -> torch.Tensor:
    """q ``[B, H, S, D]``; k, v ``[B, K, S, D]`` -> ``[B, H, S, D]``."""
    out = sdpa_plain(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                     causal)
    return out.transpose(1, 2)
