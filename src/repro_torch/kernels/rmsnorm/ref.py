"""Plain PyTorch version of the RMSNorm kernel (``csrc/rmsnorm.cu``): the
reference's ``rms_norm`` (``src/repro/models/common.py``), float32
accumulation, output in the input dtype."""

from __future__ import annotations

import torch


def rmsnorm_plain(x: torch.Tensor, gain: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last dimension of ``x`` (any leading shape)."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * gain.to(torch.float32)).to(x.dtype)
