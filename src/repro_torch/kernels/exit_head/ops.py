"""Public wrapper for the fused exit head (``csrc/exit_head.cu``).

CPU tensors go to the plain version in ``ref.py``; CUDA tensors launch the
CUDA kernel (two passes, one call), or the wrapper raises. There is no
fallback between the two.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import checks, launch_counts
from repro_torch.kernels.exit_head.ref import confidence_from, exit_head_plain

KERNEL = "exit_head"
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 7


@functools.lru_cache(maxsize=None)
def _tile_cols(code: int) -> int:
    fn = checks.launcher(KERNEL, "exit_head_tile_cols", [ctypes.c_int])
    return int(fn(code))


def exit_head(h: torch.Tensor, gain: torch.Tensor, w: torch.Tensor, *,
              eps: float = 1e-6
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused RMSNorm + unembedding + top-1 statistics.

    h ``[T, D]``; gain ``[D]``; w ``[D, V]``, all float32 or all bfloat16,
    contiguous -> (argmax ``[T]`` int32, max ``[T]`` float32, lse ``[T]``
    float32). Any T, D and V. ``confidence = exp(max - lse)``.
    """
    if h.device.type == "cpu":
        return exit_head_plain(h, gain, w, eps)
    checks.require_cuda(h, KERNEL)
    if h.ndim != 2 or w.ndim != 2:
        raise ValueError("h must be [T, D] and w [D, V]")
    t, d = h.shape
    v = w.shape[1]
    code = checks.dtype_code(h, "h")
    checks.check(h, "h", h.dtype, (t, d), h.device)
    checks.check(gain, "gain", h.dtype, (d,), h.device)
    checks.check(w, "w", h.dtype, (d, v), h.device)
    n_tiles = -(-v // _tile_cols(code))
    aligned = w.data_ptr() % 16 == 0 and (v * w.element_size()) % 16 == 0
    part_m = torch.empty((t, n_tiles), dtype=torch.float32, device=h.device)
    part_a = torch.empty((t, n_tiles), dtype=torch.int32, device=h.device)
    part_l = torch.empty((t, n_tiles), dtype=torch.float32, device=h.device)
    idx = torch.empty(t, dtype=torch.int32, device=h.device)
    mx = torch.empty(t, dtype=torch.float32, device=h.device)
    lse = torch.empty(t, dtype=torch.float32, device=h.device)
    fn = checks.launcher(KERNEL, "exit_head_launch", _ARGTYPES)
    checks.run(KERNEL, fn, h.device, h.data_ptr(), gain.data_ptr(),
               w.data_ptr(), t, d, v, float(eps), code, int(aligned),
               part_m.data_ptr(), part_a.data_ptr(), part_l.data_ptr(),
               idx.data_ptr(), mx.data_ptr(), lse.data_ptr())
    launch_counts[KERNEL] += 1
    return idx, mx, lse


__all__ = ["exit_head", "confidence_from"]
