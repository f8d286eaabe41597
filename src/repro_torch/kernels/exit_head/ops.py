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

# The launch plan (``exit_head_plan`` in the source): the entries, pass 1 on
# the tensor cores by ROWS rows, on the CUDA cores by type, ROWS and W-row
# alignment, then the fold; and the source's constants.
ENTRIES = tuple(f"tc::exit_head_tc<{r}>" for r in (1, 2, 4, 8)) + tuple(
    f"exit_head_tiles<{t}, {r}, {a}>" for t in ("float", "bf16")
    for r in (1, 2, 4, 8) for a in ("false", "true")) + ("exit_head_fold",)
PLAN_ARGTYPES = [ctypes.c_int] * 7
THREADS = 256
TC_COLS, TC_K, TC_STAGES, TC_MAX_D = 128, 64, 4, 5120
# The persistent grid's range on an H100: its SMs, and the pass-1 blocks of
# 256 threads that one SM can hold (2048 threads).
DEVICE_RANGE = {"n_sm": (1, 132), "per_sm": (1, 8)}


def _rows(t: int) -> int:
    return 1 if t == 1 else 2 if t == 2 else 4 if t <= 4 else 8


def launch_plan(t: int, d: int, v: int, dtype: int, aligned: int,
                n_sm: int = 132, per_sm: int = 1):
    """Pass 1, then the fold (a block a row). Pass 1 on the tensor cores
    (bfloat16, 16-byte W rows, D <= TC_MAX_D) is a persistent grid of as
    many blocks as ``n_sm`` SMs hold at ``per_sm`` each, every block given
    the same number of TC_COLS-column tiles, by ROWS rows, its shared
    memory (a four-stage ring of W and the normed rows) opted in; on the
    CUDA cores a block per (column tile of 128 float32 or 256 bfloat16
    columns, ROWS rows). Raises ``ValueError`` where the C entry refuses
    (tensor cores and V not a multiple of 8)."""
    if t <= 0 or v <= 0:
        return ()
    rows = _rows(t)
    slot = (1, 2, 4, 8).index(rows)
    if dtype == 1 and aligned and d <= TC_MAX_D:
        if v % 8 or n_sm < 1:
            raise ValueError(f"the tensor-core pass takes V % 8 == 0, "
                             f"got V={v}")
        n_tiles = checks.cdiv(v, TC_COLS)
        blocks = min(n_tiles, max(per_sm, 1) * n_sm)
        blocks = checks.cdiv(n_tiles, checks.cdiv(n_tiles, blocks))
        padded = checks.cdiv(d, TC_K) * TC_K
        smem = (TC_STAGES * TC_K * TC_COLS * 2 + 2 * rows * (padded + 8) * 2
                + 16 + 8 * 4 + 3 * 8 * 8 * 4)
        first = checks.Launch(
            ENTRIES[slot], (blocks, checks.cdiv(t, rows), 1), (THREADS, 1, 1),
            smem=smem, optin=True,
            tiles=((0, TC_COLS, v, True), (1, rows, t, False)))
    else:
        cols = 128 if dtype == 0 else 256
        first = checks.Launch(
            ENTRIES[4 + 8 * (dtype != 0) + 2 * slot + bool(aligned)],
            (checks.cdiv(v, cols), checks.cdiv(t, rows), 1), (THREADS, 1, 1),
            tiles=((0, cols, v, False), (1, rows, t, False)))
    return (first, checks.Launch("exit_head_fold", (t, 1, 1),
                                 (THREADS, 1, 1), tiles=((0, 1, t, False),)))


def plan_c_args(t: int, d: int, v: int, dtype: int, aligned: int,
                n_sm: int = 132, per_sm: int = 1):
    """``exit_head_plan``'s arguments for :func:`launch_plan`'s."""
    return (t, d, v, dtype, int(aligned), n_sm, per_sm)


@functools.lru_cache(maxsize=None)
def _c_query(symbol: str, code: int, aligned: bool, d: int) -> int:
    fn = checks.launcher(KERNEL, symbol, [ctypes.c_int] * 3)
    return int(fn(code, int(aligned), d))


@functools.lru_cache(maxsize=None)
def _occupancy(index: int, rows: int, d: int) -> Tuple[Tuple[str, int], ...]:
    """The tensor-core pass's card-dependent plan arguments on card
    ``index`` at ``rows`` rows a block and width ``d``, as
    ``exit_head_launch`` reads them: ``(("n_sm", SMs), ("per_sm", blocks
    resident on one))``."""
    fn = checks.launcher(KERNEL, "exit_head_occupancy",
                         [ctypes.c_int] * 2
                         + [ctypes.POINTER(ctypes.c_int)] * 2)
    sms, per = ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(index):
        err = fn(rows, d, ctypes.byref(sms), ctypes.byref(per))
    if err != 0:
        raise RuntimeError(f"{KERNEL} occupancy query failed: CUDA error "
                           f"{err}")
    return (("n_sm", sms.value), ("per_sm", per.value))


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
    point = ()
    if _c_query("exit_head_tensor_cores", code, aligned, d):
        index = (h.device.index if h.device.index is not None
                 else torch.cuda.current_device())
        point = _occupancy(index, _rows(t), d)
    checks.launching(KERNEL, point, t=t, d=d, v=v, dtype=code,
                     aligned=int(aligned))
    fn = checks.launcher(KERNEL, "exit_head_launch", _ARGTYPES)
    checks.run(KERNEL, fn, h.device, h.data_ptr(), gain.data_ptr(),
               w.data_ptr(), t, d, v, float(eps), code, int(aligned),
               part_m.data_ptr(), part_a.data_ptr(), part_l.data_ptr(),
               idx.data_ptr(), mx.data_ptr(), lse.data_ptr())
    launch_counts[KERNEL] += 1
    return idx, mx, lse


__all__ = ["exit_head", "exit_head_path", "confidence_from"]
