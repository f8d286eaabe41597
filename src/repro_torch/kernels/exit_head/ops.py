"""Public wrapper for the fused exit head (``csrc/exit_head.cu``).

CPU tensors go to the plain version in ``ref.py``; CUDA tensors launch the
CUDA kernel (two passes, one call), or the wrapper raises. There is no
fallback between the two. On the card the first pass runs on the tensor
cores for bfloat16 with 16-byte W rows and on the CUDA cores otherwise; the
kernel's C entry picks, and ``exit_head_path`` says which.
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
def _c_query(symbol: str, code: int, aligned: bool, d: int) -> int:
    fn = checks.launcher(KERNEL, symbol, [ctypes.c_int] * 3)
    return int(fn(code, int(aligned), d))


def _w_rows_aligned(w: torch.Tensor) -> bool:
    """Every row of ``w`` starts on 16 bytes (cp.async's unit)."""
    return (w.data_ptr() % 16 == 0
            and (w.shape[1] * w.element_size()) % 16 == 0)


def exit_head_path(h: torch.Tensor, w: torch.Tensor) -> str:
    """The first pass that ``exit_head(h, gain, w)`` runs: ``"plain"`` on
    the CPU; on the card ``"tensor_core"`` (bfloat16 with 16-byte W rows and
    D <= 5120) or ``"cuda_core"`` (float32, W rows that are not 16-byte
    aligned, or a larger D), as the kernel's C entry dispatches."""
    if checks.runs_plain(h):
        return "plain"
    code = checks.dtype_code(h, "h")
    tc = _c_query("exit_head_tensor_cores", code, _w_rows_aligned(w),
                  h.shape[-1])
    return "tensor_core" if tc else "cuda_core"


def exit_head(h: torch.Tensor, gain: torch.Tensor, w: torch.Tensor, *,
              eps: float = 1e-6
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused RMSNorm + unembedding + top-1 statistics.

    h ``[T, D]``; gain ``[D]``; w ``[D, V]``, all float32 or all bfloat16,
    contiguous -> (argmax ``[T]`` int32, max ``[T]`` float32, lse ``[T]``
    float32). Any T, D and V. ``confidence = exp(max - lse)``.
    """
    if checks.runs_plain(h):
        return checks.run_plain(KERNEL, exit_head_plain, h, gain, w, eps)
    checks.require_cuda(h, KERNEL)
    if h.ndim != 2 or w.ndim != 2:
        raise ValueError("h must be [T, D] and w [D, V]")
    t, d = h.shape
    v = w.shape[1]
    code = checks.dtype_code(h, "h")
    checks.check(h, "h", h.dtype, (t, d), h.device)
    checks.check(gain, "gain", h.dtype, (d,), h.device)
    checks.check(w, "w", h.dtype, (d, v), h.device)
    aligned = _w_rows_aligned(w)
    n_tiles = -(-v // _c_query("exit_head_tile_cols", code, aligned, d))
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


__all__ = ["exit_head", "exit_head_path", "confidence_from"]
