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

from typing import Callable, Optional

import torch

NEG_INF = -1e30


def sdpa_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               causal: bool, q_offset: int = 0,
               kv_len: Optional[torch.Tensor] = None, kv_offset: int = 0,
               softmax: Optional[Callable[[torch.Tensor], torch.Tensor]]
               = None) -> torch.Tensor:
    """q ``[B, Sq, H, Dh]``; k, v ``[B, Skv, K, Dh]`` (GQA by kv-head
    broadcasting) -> ``[B, Sq, H, Dv]`` in q's dtype. ``q_offset`` is the
    absolute position of q[0]; ``kv_len [B]`` masks the cache tail, where
    k[:, 0] sits at position ``kv_offset``. ``softmax`` normalises the
    float32 scores over the last dimension in place of ``torch.softmax``
    (a partition of the keys normalises across its slices with it)."""
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
        pos = torch.arange(kv_offset, kv_offset + skv, device=q.device)
        valid = pos[None, :] < kv_len[:, None]
        scores = scores.masked_fill(~valid[:, None, None, None], NEG_INF)
    probs = (torch.softmax(scores, dim=-1) if softmax is None
             else softmax(scores)).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v)
    return out.reshape(b, sq, h, v.shape[-1])


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True) -> torch.Tensor:
    """q ``[B, H, S, D]``; k, v ``[B, K, S, D]`` -> ``[B, H, S, D]``."""
    out = sdpa_plain(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                     causal)
    return out.transpose(1, 2)


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              do: torch.Tensor, causal: bool = True):
    """The gradient of :func:`flash_attention_plain` as explicit formulas
    (the backward kernel ``csrc/flash_attention_bwd.cu``'s plain version).
    q, o, do ``[B, H, S, D]``; k, v ``[B, K, S, D]``. In float32: P =
    softmax(q.k^T / sqrt(D)) (causal where asked), delta = rowsum(do * o),
    dv = P^T.do with P rounded to the input dtype first (as the forward
    rounds it before P.V), dP = do.v^T, dS = P * (dP - delta), dq = dS.k /
    sqrt(D), dk = dS^T.q / sqrt(D); the query heads of a group are summed
    into their kv head. Returns (dq, dk, dv) in the inputs' dtype."""
    b, h, s, d = q.shape
    kh = k.shape[1]
    g = h // kh
    f32 = torch.float32
    scale = (1.0 / torch.sqrt(torch.tensor(float(d)))).item()
    qf = q.to(f32).reshape(b, kh, g, s, d)
    kf, vf = k.to(f32), v.to(f32)
    dof = do.to(f32).reshape(b, kh, g, s, d)
    of = o.to(f32).reshape(b, kh, g, s, d)
    scores = torch.einsum("bkgqd,bksd->bkgqs", qf, kf) * scale
    if causal:
        pos = torch.arange(s, device=q.device)
        keep = pos[None, :] <= pos[:, None]
        scores = scores.masked_fill(~keep, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    dv = torch.einsum("bkgqs,bkgqd->bksd", p.to(q.dtype).to(f32), dof)
    dp = torch.einsum("bkgqd,bksd->bkgqs", dof, vf)
    delta = (dof * of).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta)
    dq = torch.einsum("bkgqs,bksd->bkgqd", ds, kf) * scale
    dk = torch.einsum("bkgqs,bkgqd->bksd", ds, qf) * scale
    return (dq.reshape(b, h, s, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
