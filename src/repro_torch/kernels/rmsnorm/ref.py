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


def rmsnorm_bwd_plain(x: torch.Tensor, gain: torch.Tensor, dy: torch.Tensor,
                      eps: float = 1e-6):
    """The gradient of :func:`rmsnorm_plain` as an explicit formula (the
    backward kernel ``csrc/rmsnorm_bwd.cu``'s plain version): with
    x^ = x * r and r = rsqrt(mean(x^2) + eps), all in float32,
    dx = r * (dy * g - x^ * mean(dy * g * x^)) in x's dtype and
    dgain = the sum of dy * x^ over every leading dimension, float32."""
    xf, dyf = x.to(torch.float32), dy.to(torch.float32)
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    xhat = xf * r
    dyg = dyf * gain.to(torch.float32)
    c = torch.mean(dyg * xhat, dim=-1, keepdim=True)
    dx = (r * (dyg - xhat * c)).to(x.dtype)
    dgain = (dyf * xhat).sum(dim=tuple(range(x.ndim - 1)))
    return dx, dgain
