"""Public wrapper for the flash-attention kernels
(``csrc/flash_attention.cu``).

CPU tensors go to the plain version in ``ref.py``; CUDA tensors launch a
CUDA kernel, or the wrapper raises. There is no fallback between the two.
On the card, bfloat16 runs on the tensor cores and float32 on the CUDA
cores; the dtype picks the kernel, and neither stands in for the other.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import checks, launch_counts
from repro_torch.kernels.flash_attention.ref import flash_attention_plain

KERNEL = "flash_attention"
HEAD_DIMS = (16, 32, 64, 128)
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Causal GQA attention, heads-first layout: q ``[B, H, S, D]``; k, v
    ``[B, K, S, D]`` with H % K == 0, scale 1/sqrt(D), float32 softmax.

    On the card the tensors may be strided views (only the last dimension
    must be contiguous), so ``x.transpose(1, 2)`` of a ``[B, S, H, D]``
    activation goes in without a copy; the output is allocated with q's
    memory layout. D is one of 16, 32, 64, 128; any S.

    bfloat16 tensors go to the tensor-core kernel, which copies 16-byte
    rows with ``cp.async``: every base pointer must be 16-byte aligned and
    every batch, head and position stride a multiple of 8 elements. Where
    that does not hold the wrapper raises ``ValueError``; it never copies
    to make it hold. The model's views (``x.transpose(1, 2)`` of a fresh
    ``[B, S, H, D]`` tensor, D in 16..128) always meet it.
    """
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal)
    checks.require_cuda(q, KERNEL)
    if q.ndim != 4 or k.ndim != 4:
        raise ValueError("q must be [B, H, S, D] and k, v [B, K, S, D]")
    b, h, s, d = q.shape
    kh = k.shape[1]
    if kh == 0 or h % kh:
        raise ValueError(f"H={h} is not a multiple of K={kh}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    code = checks.dtype_code(q, "q")
    for name, t, shape in (("q", q, (b, h, s, d)), ("k", k, (b, kh, s, d)),
                           ("v", v, (b, kh, s, d))):
        checks.check(t, name, q.dtype, shape, q.device, contiguous=False)
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s last dimension must be contiguous")
        if t.dtype == torch.bfloat16:
            checks.require_16_byte_rows(t, name)
    out = torch.empty_like(q)  # q's strides, or contiguous: aligned either way
    strides = (ctypes.c_int64 * 12)(*(
        st for t in (q, k, v, out) for st in t.stride()[:3]))
    fn = checks.launcher(KERNEL, "flash_attention_launch", _ARGTYPES)
    checks.run(KERNEL, fn, q.device, q.data_ptr(), k.data_ptr(),
               v.data_ptr(), out.data_ptr(), ctypes.addressof(strides),
               b, h, kh, s, d, 1.0 / math.sqrt(d), int(causal), code)
    launch_counts[KERNEL] += 1
    return out
