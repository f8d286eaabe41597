"""Shared model-substrate primitives of the port.

This slice carries what the early-exit ResNets need: the reference's
parameter initialiser (``make_param`` in ``src/repro/models/common.py``) —
a standard normal truncated to [-2, 2] times a fan-in scale — drawn from an
explicit ``torch.Generator`` on the CPU, so a seed gives the same weights
whatever device the model is moved to afterwards.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch


def truncated_normal(shape: Sequence[int], generator: torch.Generator,
                     scale: Optional[float] = None) -> torch.Tensor:
    """``scale * N(0, 1)`` truncated to [-2, 2], float32 on the CPU.

    ``scale=None`` is the reference's fan-in rule: ``1/sqrt(shape[0])``.
    The draw differs from ``jax.random.truncated_normal`` bit for bit (two
    different generators); the distribution is the same.
    """
    shape = tuple(int(s) for s in shape)
    if scale is None:
        scale = 1.0 / math.sqrt(max(shape[0] if shape else 1, 1))
    out = torch.empty(shape, dtype=torch.float32)
    torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return out.mul_(scale)
