"""Public wrappers for the RMSNorm kernels: the forward
(``csrc/rmsnorm.cu``) and its gradient (``csrc/rmsnorm_bwd.cu``).

CPU tensors go to the plain versions in ``ref.py``; CUDA tensors launch the
CUDA kernels, or the wrapper raises. There is no fallback between the two.

``rmsnorm`` and ``rmsnorm_pair`` take their direct path (one forward
launch, no graph) whenever autograd is off or no input requires a
gradient: serving never reaches the code below them. Otherwise they go
through a ``torch.autograd.Function`` whose forward is that same direct
path and whose backward is ``rmsnorm_bwd`` (``rmsnorm_pair_bwd``): the
backward kernel on the card, the plain backward on the CPU.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import checks, launch_counts
from repro_torch.kernels.rmsnorm.ref import rmsnorm_bwd_plain, rmsnorm_plain

KERNEL = "rmsnorm"
BWD_KERNEL = "rmsnorm_bwd"
BWD_LAUNCHES = 2  # the rows kernel, then the gain's fixed-order reduction
# The backward's layouts (csrc/rmsnorm_bwd.cu numbers them in this order):
# a sub-warp a row, a block of warps a row, one element at a time.
BWD_LAYOUTS = ("rows", "block", "scalar")
VEC_BYTES = 16           # a thread's loads in the two vector layouts
ROWS_MAX_NVEC = 64       # 16-byte vectors a row in the rows layout
BLOCK_MAX_NVEC = 1024    # and in the block layout (256 threads x 4)
SCALAR_MAX_D = 32768     # the scalar layout's [rows in flight][D] floats
ROW_THREADS = 256        # threads of a block holding several rows
# Blocks to aim for: four a streaming multiprocessor of an H100 (132); each
# block takes at least MIN_ROWS_PER_BLOCK rows, so the [blocks, D] float32
# partial of the gain's gradient holds at most an eighth of the rows.
TARGET_BLOCKS = 4 * 132
MIN_ROWS_PER_BLOCK = 8
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int,
                                     ctypes.c_float, ctypes.c_int,
                                     ctypes.c_void_p]
_PAIR_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int]) * 2 + [
    ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
_BWD_PAIR_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int]) * 2 + [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_float] + [ctypes.c_int] * 5 + [
    ctypes.c_void_p]


def bwd_row_threads(layout: str, d: int, dtype: torch.dtype):
    """(threads a row, rows in flight a block) of the backward's ``layout``
    at width ``d``: the rows layout gives a row 4, 8, 16 or 32 lanes (each
    up to 2 vectors), the block layout 32 per 64 vectors up to ROW_THREADS,
    the scalar layout a warp up to D = 1024, else 256 threads; a block
    holds ROW_THREADS // threads rows, at least one."""
    nvec = d * torch.tensor([], dtype=dtype).element_size() // VEC_BYTES
    if layout == "rows":
        lanes = next(n for n in (4, 8, 16, 32) if nvec <= n or n == 32)
    elif layout == "block":
        lanes = min(ROW_THREADS, 32 * -(-nvec // 64))
    else:
        lanes = 32 if d <= 1024 else 256
    return lanes, max(1, ROW_THREADS // lanes)


def bwd_plan(rows: int, d: int, dtype: torch.dtype, aligned: bool):
    """The backward's launch plan for one tensor of ``rows`` x ``d``:
    (layout, blocks, rows per block), a fixed function of its arguments
    (never of the device), so the gain's gradient sums in the same order
    on any card. ``aligned``: every base address 16 bytes aligned.

    The layout follows the row's 16-byte vectors (nvec = d * size / 16):
    "rows" up to ROWS_MAX_NVEC, "block" up to BLOCK_MAX_NVEC, "scalar"
    where D * size is not a multiple of 16 bytes, an address is not
    aligned, or nvec is larger. Rows per block: enough that the tensor
    takes about TARGET_BLOCKS blocks, at least MIN_ROWS_PER_BLOCK, rounded
    up to whole rounds of the block's rows in flight; blocks = ceil(rows /
    rows per block) (0 for no rows)."""
    size = torch.tensor([], dtype=dtype).element_size()
    nvec, ragged = divmod(d * size, VEC_BYTES)
    if not aligned or ragged or nvec > BLOCK_MAX_NVEC:
        layout = "scalar"
        if d > SCALAR_MAX_D:
            raise ValueError(f"D={d} needs the scalar layout, which takes "
                             f"D <= {SCALAR_MAX_D}")
    else:
        layout = "rows" if nvec <= ROWS_MAX_NVEC else "block"
    _, slots = bwd_row_threads(layout, d, dtype)
    per = max(MIN_ROWS_PER_BLOCK, -(-rows // TARGET_BLOCKS))
    per = -(-per // slots) * slots
    return layout, -(-rows // per), per


def _check(x: torch.Tensor, gain: torch.Tensor, name: str,
           kernel: str = KERNEL) -> int:
    """Raise unless ``x`` is a contiguous ``[T, D]`` card tensor of a type
    the kernel takes, with a ``[D]`` gain of the same type; returns its
    dtype code."""
    checks.require_cuda(x, kernel)
    if x.ndim != 2:
        raise ValueError(f"{name} must be [T, D], got shape {tuple(x.shape)}")
    code = checks.dtype_code(x, name)
    checks.check(x, name, x.dtype, x.shape, x.device)
    checks.check(gain, f"gain of {name}", x.dtype, (x.shape[1],), x.device)
    return code


def _wants_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _rmsnorm(x: torch.Tensor, gain: torch.Tensor, eps: float) -> torch.Tensor:
    if checks.runs_plain(x):
        return checks.run_plain(KERNEL, rmsnorm_plain, x, gain, eps)
    code = _check(x, gain, "x")
    t, d = x.shape
    out = torch.empty_like(x)
    fn = checks.launcher(KERNEL, "rmsnorm_launch", _ARGTYPES)
    checks.run(KERNEL, fn, x.device, x.data_ptr(), gain.data_ptr(),
               out.data_ptr(), t, d, float(eps), code)
    launch_counts[KERNEL] += 1
    return out


def _plain_pair(xq, gq, xk, gk, eps):
    return rmsnorm_plain(xq, gq, eps), rmsnorm_plain(xk, gk, eps)


def _plain_bwd_pair(xq, gq, dyq, xk, gk, dyk, eps):
    return (*rmsnorm_bwd_plain(xq, gq, dyq, eps),
            *rmsnorm_bwd_plain(xk, gk, dyk, eps))


def _check_pair(xq: torch.Tensor, gq: torch.Tensor, xk: torch.Tensor,
                gk: torch.Tensor, kernel: str) -> int:
    code = _check(xq, gq, "xq", kernel)
    _check(xk, gk, "xk", kernel)
    if xk.dtype != xq.dtype or xk.device != xq.device:
        raise TypeError(f"xk ({xk.dtype}, {xk.device}) must match xq "
                        f"({xq.dtype}, {xq.device})")
    if xk.shape[1] != xq.shape[1]:
        raise ValueError(f"xq and xk need one D, got {xq.shape[1]} and "
                         f"{xk.shape[1]}")
    return code


def _rmsnorm_pair(xq: torch.Tensor, gq: torch.Tensor, xk: torch.Tensor,
                  gk: torch.Tensor, eps: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    if checks.runs_plain(xq):
        return checks.run_plain(KERNEL, _plain_pair, xq, gq, xk, gk, eps)
    code = _check_pair(xq, gq, xk, gk, KERNEL)
    oq, ok = torch.empty_like(xq), torch.empty_like(xk)
    fn = checks.launcher(KERNEL, "rmsnorm_pair_launch", _PAIR_ARGTYPES)
    checks.run(KERNEL, fn, xq.device,
               xq.data_ptr(), gq.data_ptr(), oq.data_ptr(), xq.shape[0],
               xk.data_ptr(), gk.data_ptr(), ok.data_ptr(), xk.shape[0],
               xq.shape[1], float(eps), code)
    launch_counts[KERNEL] += 1
    return oq, ok


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gain, eps):
        ctx.save_for_backward(x, gain)
        ctx.eps = eps
        return _rmsnorm(x, gain, eps)

    @staticmethod
    def backward(ctx, dy):
        x, gain = ctx.saved_tensors
        dx, dgain = rmsnorm_bwd(x, gain, dy.contiguous(), eps=ctx.eps)
        return dx, dgain.to(gain.dtype), None


class _RMSNormPair(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xq, gq, xk, gk, eps):
        ctx.save_for_backward(xq, gq, xk, gk)
        ctx.eps = eps
        return _rmsnorm_pair(xq, gq, xk, gk, eps)

    @staticmethod
    def backward(ctx, dyq, dyk):
        xq, gq, xk, gk = ctx.saved_tensors
        dxq, dgq, dxk, dgk = rmsnorm_pair_bwd(
            xq, gq, dyq.contiguous(), xk, gk, dyk.contiguous(), eps=ctx.eps)
        return dxq, dgq.to(gq.dtype), dxk, dgk.to(gk.dtype), None


def rmsnorm(x: torch.Tensor, gain: torch.Tensor, *,
            eps: float = 1e-6) -> torch.Tensor:
    """x ``[T, D]`` and gain ``[D]``, both float32 or both bfloat16 ->
    ``[T, D]`` in x's dtype; one launch on the card. Differentiable: with
    autograd on and an input that requires a gradient, the backward runs
    :func:`rmsnorm_bwd`."""
    if _wants_grad(x, gain):
        return _RMSNorm.apply(x, gain, eps)
    return _rmsnorm(x, gain, eps)


def rmsnorm_pair(xq: torch.Tensor, gq: torch.Tensor, xk: torch.Tensor,
                 gk: torch.Tensor, *, eps: float = 1e-6
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(rmsnorm(xq, gq), rmsnorm(xk, gk))`` for xq ``[T_q, D]`` and xk
    ``[T_k, D]`` of one dtype, in one launch on the card (a model's per-head
    q and k norms); on the CPU, two calls of the plain version.
    Differentiable as :func:`rmsnorm`, through :func:`rmsnorm_pair_bwd`."""
    if _wants_grad(xq, gq, xk, gk):
        return _RMSNormPair.apply(xq, gq, xk, gk, eps)
    return _rmsnorm_pair(xq, gq, xk, gk, eps)


def _bwd_launch(x, gain, dy, xk=None, gk=None, dyk=None, eps=1e-6):
    """The backward kernel's two launches for one tensor, or for the pair
    when ``xk`` is given; returns (dx, dgain[, dxk, dgk])."""
    pair = xk is not None
    code = (_check_pair(x, gain, xk, gk, BWD_KERNEL) if pair
            else _check(x, gain, "x", BWD_KERNEL))
    checks.check(dy, "dy", x.dtype, x.shape, x.device)
    if pair:
        checks.check(dyk, "dyk", xk.dtype, xk.shape, xk.device)
    d = x.shape[1]
    t_k = xk.shape[0] if pair else 0
    tensors = (x, gain, dy, xk, gk, dyk) if pair else (x, gain, dy)
    aligned = all(t.data_ptr() % VEC_BYTES == 0 for t in tensors)
    layout, blocks, per = bwd_plan(x.shape[0], d, x.dtype, aligned)
    _, blocks_k, per_k = bwd_plan(t_k, d, x.dtype, aligned)
    lanes, _ = bwd_row_threads(layout, d, x.dtype)
    partial = torch.empty((max(blocks + blocks_k, 1), d),
                          dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    dg = torch.empty(d, dtype=torch.float32, device=x.device)
    dxk = torch.empty_like(xk) if pair else None
    dgk = torch.empty(d, dtype=torch.float32, device=x.device) if pair \
        else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    fn = checks.launcher(BWD_KERNEL, "rmsnorm_pair_bwd_launch",
                         _BWD_PAIR_ARGTYPES)
    checks.run(BWD_KERNEL, fn, x.device,
               x.data_ptr(), gain.data_ptr(), dy.data_ptr(), dx.data_ptr(),
               dg.data_ptr(), x.shape[0], ptr(xk), ptr(gk), ptr(dyk),
               ptr(dxk), ptr(dgk), t_k, partial.data_ptr(), d, float(eps),
               code, BWD_LAYOUTS.index(layout), lanes, per, per_k)
    launch_counts[BWD_KERNEL] += BWD_LAUNCHES
    return (dx, dg, dxk, dgk) if pair else (dx, dg)


def rmsnorm_bwd(x: torch.Tensor, gain: torch.Tensor, dy: torch.Tensor, *,
                eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradient of :func:`rmsnorm` at x ``[T, D]`` and gain ``[D]``
    for the output gradient dy ``[T, D]`` (all one dtype, contiguous):
    (dx in x's dtype, dgain float32). Two launches on the card (the rows,
    each read once, by the plan :func:`bwd_plan` gives; then the gain's
    reduction in a fixed order: no float atomics, so the bits repeat); the
    plain backward on the CPU."""
    if checks.runs_plain(x):
        return checks.run_plain(BWD_KERNEL, rmsnorm_bwd_plain, x, gain, dy,
                                eps)
    return _bwd_launch(x, gain, dy, eps=eps)


def rmsnorm_pair_bwd(xq: torch.Tensor, gq: torch.Tensor, dyq: torch.Tensor,
                     xk: torch.Tensor, gk: torch.Tensor, dyk: torch.Tensor,
                     *, eps: float = 1e-6):
    """The gradient of :func:`rmsnorm_pair`: (dxq, dgq, dxk, dgk), both
    tensors in the same two launches on the card; two plain backwards on
    the CPU."""
    if checks.runs_plain(xq):
        return checks.run_plain(BWD_KERNEL, _plain_bwd_pair, xq, gq, dyq, xk,
                                gk, dyk, eps)
    return _bwd_launch(xq, gq, dyq, xk, gk, dyk, eps=eps)
