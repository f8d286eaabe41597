"""Shared model-substrate primitives of the port (reference
``src/repro/models/common.py``): the parameter initialiser, norms,
activations, rotary position embeddings and the vocab-padding mask.

Parameters are drawn from an explicit ``torch.Generator`` on the
generator's own device (the CPU for the ResNets and the tests; the card for
the served LMs, whose 12.8 billion values would take tens of seconds to draw
on the host). A seed gives the same weights on the same device; the draw
differs from ``jax.random`` bit for bit (two different generators), the
distribution is the same.

``rms_norm`` and ``rms_norm_pair`` go through the RMSNorm kernel's wrappers:
the plain version on a CPU tensor, the CUDA kernel on a card tensor.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.rmsnorm.ops import rmsnorm, rmsnorm_pair


def truncated_normal(shape: Sequence[int], generator: torch.Generator,
                     scale: Optional[float] = None) -> torch.Tensor:
    """``scale * N(0, 1)`` truncated to [-2, 2], float32 on the generator's
    device.

    ``scale=None`` is the reference's fan-in rule: ``1/sqrt(shape[0])``.
    """
    shape = tuple(int(s) for s in shape)
    if scale is None:
        scale = 1.0 / math.sqrt(max(shape[0] if shape else 1, 1))
    out = torch.empty(shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return out.mul_(scale)


def make_param(shape: Sequence[int], generator: torch.Generator,
               init: str = "normal", scale: Optional[float] = None,
               dtype: torch.dtype = torch.float32) -> torch.nn.Parameter:
    """The reference's ``make_param`` as a frozen ``nn.Parameter`` on the
    generator's device: ``"normal"`` (truncated normal, fan-in
    ``shape[0]`` unless ``scale`` is given), ``"embedding"`` (fan-in
    ``shape[-1]``), ``"zeros"`` or ``"ones"``. Drawn in float32, then cast
    to ``dtype``, as the reference casts its float32 parameters at the
    forward's entry."""
    shape = tuple(int(s) for s in shape)
    device = generator.device
    if init == "zeros":
        value = torch.zeros(shape, dtype=dtype, device=device)
    elif init == "ones":
        value = torch.ones(shape, dtype=dtype, device=device)
    elif init in ("normal", "embedding"):
        if scale is None:
            fan_in = shape[-1] if init == "embedding" else (
                shape[0] if shape else 1)
            scale = 1.0 / math.sqrt(max(fan_in, 1))
        value = truncated_normal(shape, generator, scale).to(dtype)
    else:
        raise ValueError(f"unknown init {init!r}")
    return torch.nn.Parameter(value, requires_grad=False)


# ---------------------------------------------------------------------------
# Norms / activations
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last dimension in float32 accumulation, cast back to
    x's dtype; one RMSNorm kernel launch on the card."""
    d = x.shape[-1]
    return rmsnorm(x.reshape(-1, d).contiguous(), weight, eps=eps).reshape(
        x.shape)


def rms_norm_pair(q: torch.Tensor, q_weight: torch.Tensor, k: torch.Tensor,
                  k_weight: torch.Tensor, eps: float = 1e-6
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(rms_norm(q, q_weight), rms_norm(k, k_weight))`` for two tensors of
    one last dimension; one RMSNorm kernel launch on the card."""
    d = q.shape[-1]
    nq, nk = rmsnorm_pair(q.reshape(-1, d).contiguous(), q_weight,
                          k.reshape(-1, d).contiguous(), k_weight, eps=eps)
    return nq.reshape(q.shape), nk.reshape(k.shape)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate) * up


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float = 10000.0,
                     device: Optional[torch.device] = None) -> torch.Tensor:
    """``[head_dim/2]`` float32 inverse frequencies."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)


def rope_rotation(positions: torch.Tensor, head_dim: int,
                  theta: float = 10000.0) -> torch.Tensor:
    """cos + i sin of every (position, frequency): complex64
    ``[..., S, 1, head_dim/2]`` for ``positions [..., S]``."""
    inv = rope_frequencies(head_dim, theta, device=positions.device)
    ang = positions[..., :, None, None].to(torch.float32) * inv
    return torch.polar(torch.ones_like(ang), ang)


@functools.lru_cache(maxsize=64)
def prefix_rotation(s: int, head_dim: int, theta: float,
                    device: torch.device) -> torch.Tensor:
    """``rope_rotation`` of positions 0..s-1, made once per (s, head_dim,
    theta, device): every layer of every prefill shares it."""
    return rope_rotation(torch.arange(s, device=device), head_dim, theta)


def rotate(x: torch.Tensor, rotation: torch.Tensor) -> torch.Tensor:
    """Rotate the pairs (x[2i], x[2i+1]) of ``x [..., S, H, D]`` by
    ``rotation`` (from ``rope_rotation``), in float32, back to x's dtype."""
    d = x.shape[-1]
    pairs = torch.view_as_complex(
        x.to(torch.float32).contiguous().reshape(*x.shape[:-1], d // 2, 2))
    return torch.view_as_real(pairs * rotation).reshape(x.shape).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """Rotate ``x [..., S, H, D]`` by ``positions [..., S]``
    (broadcastable).

    Pairs (x[2i], x[2i+1]) are rotated: the interleaved convention of the
    reference, not Hugging Face's rotate-half. Each pair is one complex
    number, so the rotation is one complex product in float32.
    """
    return rotate(x, rope_rotation(positions.to(x.device), x.shape[-1],
                                   theta))


def mask_padded_vocab(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """Mask sharding-padding vocab slots to -1e30 (no-op when unpadded)."""
    if logits.shape[-1] == vocab:
        return logits
    keep = torch.arange(logits.shape[-1], device=logits.device) < vocab
    return logits.masked_fill(~keep, -1e30)
