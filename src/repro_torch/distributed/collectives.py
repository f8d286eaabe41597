"""Distributed-optimization collectives (reference
``src/repro/distributed/collectives.py``).

``compressed_psum``: int8-quantised gradient all-reduce, an O(4x)
reduction of the gradient all-reduce volume for DP/FSDP training at
1000+ node scale, where the cross-pod links are the binding constraint.
Gradients are quantised per-tensor with a shared scale, summed in int32,
dequantised, and the quantisation error is fed back into the next step's
gradients (``quantize_tree``; error feedback keeps SGD convergence
unbiased to first order).

The reference declares ``TrainConfig.compress_grads`` and never reads it;
neither does the port's trainer.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

Tree = Dict[str, torch.Tensor]


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantisation. Returns (q, scale), scale a
    float32 scalar tensor. ``torch.round`` rounds half to even, as
    ``jnp.round`` does."""
    x32 = x.to(torch.float32)
    absmax = torch.max(torch.abs(x32))
    scale = torch.clamp(absmax / 127.0, min=1e-12)
    q = torch.clamp(torch.round(x32 / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """int8-compressed sum of ``x`` over the ranks of ``group`` (default:
    the default process group).

    The int8 payload is summed in int32 (no overflow for <= 2^23 workers);
    scales are max-reduced so dequantisation is conservative.
    """
    q, scale = quantize_int8(x)
    q_sum = q.to(torch.int32)
    dist.all_reduce(q_sum, op=dist.ReduceOp.SUM, group=group)
    scale_max = scale.clone()
    dist.all_reduce(scale_max, op=dist.ReduceOp.MAX, group=group)
    return dequantize_int8(q_sum, scale_max).to(x.dtype)


def quantize_tree(grads: Tree, error: Optional[Tree]
                  ) -> Tuple[Tree, Tree, Tree]:
    """Error-feedback quantisation of a gradient tree (a flat dict).

    Returns (quantised-dequantised grads, scales, new error residuals).
    ``error`` (the previous residual) is added before quantising; the new
    residual is kept for the next step.
    """
    if error is None:
        error = {k: torch.zeros_like(g, dtype=torch.float32)
                 for k, g in grads.items()}
    deq, scales, residual = {}, {}, {}
    for k, g in grads.items():
        g32 = g.to(torch.float32) + error[k]
        q, scale = quantize_int8(g32)
        d = dequantize_int8(q, scale)
        deq[k], scales[k], residual[k] = d.to(g.dtype), scale, g32 - d
    return deq, scales, residual


__all__ = ["compressed_psum", "dequantize_int8", "quantize_int8",
           "quantize_tree"]
