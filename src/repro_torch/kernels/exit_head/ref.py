"""Plain PyTorch version of the fused exit head (``csrc/exit_head.cu``):
the reference's oracle (``src/repro/kernels/exit_head/ref.py``).

exit_head(h, g, W) = (argmax, max, logsumexp) of ``rmsnorm(h; g) @ W`` in
float32; the argmax is the first on ties. Confidence = exp(max - lse).
"""

from __future__ import annotations

from typing import Tuple

import torch


def exit_head_logits(h: torch.Tensor, gain: torch.Tensor, w: torch.Tensor,
                     eps: float = 1e-6) -> torch.Tensor:
    """h ``[T, D]``; gain ``[D]``; w ``[D, V]`` -> ``rmsnorm(h; g) @ W``
    ``[T, V]`` in float32."""
    hf = h.to(torch.float32)
    var = torch.mean(hf * hf, dim=-1, keepdim=True)
    normed = hf * torch.rsqrt(var + eps) * gain.to(torch.float32)
    return normed @ w.to(torch.float32)


def exit_head_plain(h: torch.Tensor, gain: torch.Tensor, w: torch.Tensor,
                    eps: float = 1e-6
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """h ``[T, D]``; gain ``[D]``; w ``[D, V]`` ->
    (argmax ``[T]`` int32, max ``[T]`` float32, lse ``[T]`` float32)."""
    logits = exit_head_logits(h, gain, w, eps)
    # torch.argmax, like jnp.argmax, returns the first maximal index
    return (torch.argmax(logits, dim=-1).to(torch.int32),
            torch.amax(logits, dim=-1), torch.logsumexp(logits, dim=-1))


def confidence_from(max_logit: torch.Tensor, lse: torch.Tensor
                    ) -> torch.Tensor:
    """Top-1 softmax probability (the paper-style exit confidence)."""
    return torch.exp(max_logit - lse)
