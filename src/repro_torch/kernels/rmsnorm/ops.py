"""Public wrapper for the RMSNorm kernel (``csrc/rmsnorm.cu``).

CPU tensors go to the plain version in ``ref.py``; CUDA tensors launch the
CUDA kernel, or the wrapper raises. There is no fallback between the two.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import checks, launch_counts
from repro_torch.kernels.rmsnorm.ref import rmsnorm_plain

KERNEL = "rmsnorm"
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int,
                                     ctypes.c_float, ctypes.c_int,
                                     ctypes.c_void_p]


def rmsnorm(x: torch.Tensor, gain: torch.Tensor, *,
            eps: float = 1e-6) -> torch.Tensor:
    """x ``[T, D]`` and gain ``[D]``, both float32 or both bfloat16 ->
    ``[T, D]`` in x's dtype; one launch on the card."""
    if x.device.type == "cpu":
        return rmsnorm_plain(x, gain, eps)
    checks.require_cuda(x, KERNEL)
    if x.ndim != 2:
        raise ValueError(f"x must be [T, D], got shape {tuple(x.shape)}")
    t, d = x.shape
    code = checks.dtype_code(x, "x")
    checks.check(x, "x", x.dtype, (t, d), x.device)
    checks.check(gain, "gain", x.dtype, (d,), x.device)
    out = torch.empty_like(x)
    fn = checks.launcher(KERNEL, "rmsnorm_launch", _ARGTYPES)
    checks.run(KERNEL, fn, x.device, x.data_ptr(), gain.data_ptr(),
               out.data_ptr(), t, d, float(eps), code)
    launch_counts[KERNEL] += 1
    return out
