"""Public wrappers for the RMSNorm kernel (``csrc/rmsnorm.cu``).

CPU tensors go to the plain version in ``ref.py``; CUDA tensors launch the
CUDA kernel, or the wrapper raises. There is no fallback between the two.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import checks, launch_counts
from repro_torch.kernels.rmsnorm.ref import rmsnorm_plain

KERNEL = "rmsnorm"
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int,
                                     ctypes.c_float, ctypes.c_int,
                                     ctypes.c_void_p]
_PAIR_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int]) * 2 + [
    ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def _check(x: torch.Tensor, gain: torch.Tensor, name: str) -> int:
    """Raise unless ``x`` is a contiguous ``[T, D]`` card tensor of a type
    the kernel takes, with a ``[D]`` gain of the same type; returns its
    dtype code."""
    checks.require_cuda(x, KERNEL)
    if x.ndim != 2:
        raise ValueError(f"{name} must be [T, D], got shape {tuple(x.shape)}")
    code = checks.dtype_code(x, name)
    checks.check(x, name, x.dtype, x.shape, x.device)
    checks.check(gain, f"gain of {name}", x.dtype, (x.shape[1],), x.device)
    return code


def rmsnorm(x: torch.Tensor, gain: torch.Tensor, *,
            eps: float = 1e-6) -> torch.Tensor:
    """x ``[T, D]`` and gain ``[D]``, both float32 or both bfloat16 ->
    ``[T, D]`` in x's dtype; one launch on the card."""
    if x.device.type == "cpu":
        return rmsnorm_plain(x, gain, eps)
    code = _check(x, gain, "x")
    t, d = x.shape
    out = torch.empty_like(x)
    fn = checks.launcher(KERNEL, "rmsnorm_launch", _ARGTYPES)
    checks.run(KERNEL, fn, x.device, x.data_ptr(), gain.data_ptr(),
               out.data_ptr(), t, d, float(eps), code)
    launch_counts[KERNEL] += 1
    return out


def rmsnorm_pair(xq: torch.Tensor, gq: torch.Tensor, xk: torch.Tensor,
                 gk: torch.Tensor, *, eps: float = 1e-6
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(rmsnorm(xq, gq), rmsnorm(xk, gk))`` for xq ``[T_q, D]`` and xk
    ``[T_k, D]`` of one dtype, in one launch on the card (a model's per-head
    q and k norms); on the CPU, two calls of the plain version."""
    if xq.device.type == "cpu":
        return rmsnorm_plain(xq, gq, eps), rmsnorm_plain(xk, gk, eps)
    code = _check(xq, gq, "xq")
    _check(xk, gk, "xk")
    if xk.dtype != xq.dtype or xk.device != xq.device:
        raise TypeError(f"xk ({xk.dtype}, {xk.device}) must match xq "
                        f"({xq.dtype}, {xq.device})")
    if xk.shape[1] != xq.shape[1]:
        raise ValueError(f"xq and xk need one D, got {xq.shape[1]} and "
                         f"{xk.shape[1]}")
    oq, ok = torch.empty_like(xq), torch.empty_like(xk)
    fn = checks.launcher(KERNEL, "rmsnorm_pair_launch", _PAIR_ARGTYPES)
    checks.run(KERNEL, fn, xq.device,
               xq.data_ptr(), gq.data_ptr(), oq.data_ptr(), xq.shape[0],
               xk.data_ptr(), gk.data_ptr(), ok.data_ptr(), xk.shape[0],
               xq.shape[1], float(eps), code)
    launch_counts[KERNEL] += 1
    return oq, ok
