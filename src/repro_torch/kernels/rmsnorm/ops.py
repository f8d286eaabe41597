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

# The launch plans (``rmsnorm_plan`` and ``rmsnorm_bwd_plan`` in the
# sources): the entries of each type, float then bfloat16.
_TYPES = ("float", "bf16")
DTYPES = {0: torch.float32, 1: torch.bfloat16}
ENTRIES = tuple(
    name for t in _TYPES for name in (
        *(f"rmsnorm_vec_rows_kernel<{t}, {lanes}, {v}>"
          for lanes in (4, 8, 16, 32) for v in (1, 2, 3, 4)),
        f"rmsnorm_vec_block_kernel<{t}>", f"rmsnorm_rows_kernel<{t}>",
        f"rmsnorm_kernel<{t}, 128>", f"rmsnorm_kernel<{t}, 256>"))
BWD_ENTRIES = tuple(
    name for t in _TYPES for name in (
        *(f"rmsnorm_bwd_vec_kernel<{t}, {v}>" for v in (1, 2, 3, 4)),
        f"rmsnorm_bwd_scalar_kernel<{t}>")) + ("rmsnorm_bwd_reduce",)
PLAN_ARGTYPES = [ctypes.c_int] * 5
BWD_PLAN_ARGTYPES = [ctypes.c_int] * 10
# the forward's layouts: 256-thread blocks of LANES-lane rows up to
# 32 x FWD_BLOCK_VECS vectors, a block a row (32 x FWD_BLOCK_VECS vectors a
# warp) up to 32 times that, else a warp a row up to D = 512 (8 rows a
# block) and a block of 128 or 256 threads a row above; the backward's
# reduction takes 32 columns by 32 lanes a block
FWD_BLOCK_VECS, RED_COLS, RED_LANES = 4, 32, 32


def _rows_segments(per: int, t_a: int, t_b: int, per_b: int = 0):
    """The rows axis' tiles: a's blocks, then b's."""
    return tuple((0, p, t, False) for p, t in ((per, t_a), (per_b or per,
                                                             t_b)) if t > 0)


def launch_plan(t_a: int, t_b: int, d: int, dtype: int, aligned: int):
    """The forward's one launch over both tensors (a's blocks first), as
    the source picks its layout: 16-byte vectors where D allows and every
    address is aligned (LANES lanes a row, or a block a row past 128
    vectors), else a warp a row up to D = 512 and a block a row above.
    The kernels address a row's columns with 32-bit offsets."""
    if t_a < 0 or t_b < 0 or t_a + t_b == 0 or d <= 0:
        return ()
    t = _TYPES[dtype != 0]
    elems = VEC_BYTES // (4 if dtype == 0 else 2)
    nvec = d // elems
    vec = d % elems == 0 and nvec <= 32 * FWD_BLOCK_VECS * 32 and aligned
    if vec and nvec <= 32 * FWD_BLOCK_VECS:
        lanes = next(n for n in (4, 8, 16, 32) if nvec <= n or n == 32)
        v = min(checks.cdiv(nvec, lanes), 4)
        entry, threads = f"rmsnorm_vec_rows_kernel<{t}, {lanes}, {v}>", 256
        per = 256 // lanes
    elif vec:
        entry = f"rmsnorm_vec_block_kernel<{t}>"
        threads, per = 32 * checks.cdiv(nvec, 32 * FWD_BLOCK_VECS), 1
    elif d <= 512:
        entry, threads, per = f"rmsnorm_rows_kernel<{t}>", 256, 8
    else:
        threads = 128 if d <= 1024 else 256
        entry, per = f"rmsnorm_kernel<{t}, {threads}>", 1
    return (checks.Launch(
        entry, (checks.cdiv(t_a, per) + checks.cdiv(t_b, per), 1, 1),
        (threads, 1, 1), tiles=_rows_segments(per, t_a, t_b),
        index32=(("a row", d),)),)


def plan_c_args(t_a: int, t_b: int, d: int, dtype: int, aligned: int):
    """``rmsnorm_plan``'s arguments for :func:`launch_plan`'s."""
    return (t_a, t_b, d, dtype, int(aligned))


def _bwd_args(t_a: int, t_b: int, d: int, dtype: int, aligned: int):
    """(layout, lanes, rows a block of a and of b) of the backward, as
    :func:`_bwd_launch` passes them."""
    torch_dtype = DTYPES[dtype]
    layout, _, per_a = bwd_plan(t_a, d, torch_dtype, bool(aligned))
    _, _, per_b = bwd_plan(t_b, d, torch_dtype, bool(aligned))
    lanes, _ = bwd_row_threads(layout, d, torch_dtype)
    return layout, lanes, per_a, per_b


def bwd_launch_plan(t_a: int, t_b: int, d: int, dtype: int, aligned: int,
                    two: int):
    """The backward's launches: the rows (none where both tensors are
    empty) by :func:`bwd_plan`'s layout, ``lanes`` threads a row and its
    rows a block, their [slots, D] float fold in dynamic shared memory
    (opted in past 48 KB); then the gains' reduction, a block per
    (RED_COLS columns, gain). ``two``: a second gain (the pair)."""
    layout, lanes, per_a, per_b = _bwd_args(t_a, t_b, d, dtype, aligned)
    t = _TYPES[dtype != 0]
    slots = 1 if lanes >= ROW_THREADS else ROW_THREADS // lanes
    smem = slots * d * 4 if slots > 1 or layout == "scalar" else 0
    blocks = sum(checks.cdiv(n, per) for n, per in ((t_a, per_a),
                                                   (t_b, per_b)) if n > 0)
    out = []
    if blocks:
        nvec = d * (4 if dtype == 0 else 2) // VEC_BYTES
        entry = (f"rmsnorm_bwd_scalar_kernel<{t}>" if layout == "scalar"
                 else f"rmsnorm_bwd_vec_kernel<{t}, "
                      f"{checks.cdiv(nvec, lanes)}>")
        out.append(checks.Launch(
            entry, (blocks, 1, 1), (lanes * slots, 1, 1), smem=smem,
            optin=smem > 48 * 1024,
            tiles=_rows_segments(per_a, t_a, t_b, per_b),
            index32=(("a row", d),)))
    out.append(checks.Launch(
        "rmsnorm_bwd_reduce", (checks.cdiv(d, RED_COLS), 2 if two else 1, 1),
        (RED_COLS, RED_LANES, 1), tiles=((0, RED_COLS, d, False),)))
    return tuple(out)


def bwd_plan_c_args(t_a: int, t_b: int, d: int, dtype: int, aligned: int,
                    two: int):
    """``rmsnorm_bwd_plan``'s arguments for :func:`bwd_launch_plan`'s."""
    layout, lanes, per_a, per_b = _bwd_args(t_a, t_b, d, dtype, aligned)
    return (t_a, t_b, d, dtype, BWD_LAYOUTS.index(layout), lanes, per_a,
            per_b, int(aligned), int(two))


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


def _aligned(*tensors: torch.Tensor) -> int:
    """1 where every base address is 16-byte aligned."""
    return int(all(t.data_ptr() % VEC_BYTES == 0 for t in tensors))


def _wants_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _rmsnorm(x: torch.Tensor, gain: torch.Tensor, eps: float) -> torch.Tensor:
    if checks.runs_plain(x):
        return checks.run_plain(KERNEL, rmsnorm_plain, x, gain, eps)
    code = _check(x, gain, "x")
    t, d = x.shape
    out = torch.empty_like(x)
    checks.launching(KERNEL, t_a=t, t_b=0, d=d, dtype=code,
                     aligned=_aligned(x, gain, out))
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
    checks.launching(KERNEL, t_a=xq.shape[0], t_b=xk.shape[0],
                     d=xq.shape[1], dtype=code,
                     aligned=(_aligned(xq, gq, oq) or not xq.shape[0])
                     and (_aligned(xk, gk, ok) or not xk.shape[0]))
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

    checks.launching(BWD_KERNEL, t_a=x.shape[0], t_b=t_k, d=d, dtype=code,
                     aligned=int(aligned), two=int(pair))
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
