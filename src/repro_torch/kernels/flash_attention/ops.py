"""Public wrappers for the flash-attention kernels: the forward
(``csrc/flash_attention.cu``) and its gradient
(``csrc/flash_attention_bwd.cu``).

CPU tensors go to the plain versions in ``ref.py``; CUDA tensors launch a
CUDA kernel, or the wrapper raises. There is no fallback between the two.
On the card, the forward runs bfloat16 on the tensor cores and float32 on
the CUDA cores; the dtype picks the kernel, and neither stands in for the
other.

``flash_attention`` takes its direct path (one forward launch, no graph)
whenever autograd is off or no input requires a gradient: serving never
reaches the code below it. Otherwise it goes through a
``torch.autograd.Function`` whose forward is that same direct path, saving
q, k, v and the output, and whose backward is ``flash_attention_bwd``: the
backward kernel on the card, the plain backward on the CPU.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import checks, launch_counts
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_bwd_plain,
    flash_attention_plain,
)

KERNEL = "flash_attention"
BWD_KERNEL = "flash_attention_bwd"
BWD_LAUNCHES = 2  # dq (with each row's lse and delta), then dk and dv
BWD_TILE = 64  # positions of a tile: the scratch rows are padded to it
HEAD_DIMS = (16, 32, 64, 128)
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_BWD_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]

# The launch plans (``flash_attention_plan`` and ``flash_attention_bwd_plan``
# in the sources): entries by head dim, tc:: (bfloat16 on the tensor cores)
# then f32:: (float32 on the CUDA cores). Both plans take (B, H, K, S, D,
# dtype code).
ENTRIES = tuple(f"{ns}::flash_attention_kernel<{d}>" for ns in ("tc", "f32")
                for d in HEAD_DIMS)
BWD_ENTRIES = tuple(f"tc::{k}<{d}>" for k in ("dq_kernel", "dkv_kernel")
                    for d in HEAD_DIMS) + tuple(
    f"f32::{k}<float, {d}>" for k in ("dq_kernel", "dkv_kernel")
    for d in HEAD_DIMS)
PLAN_ARGTYPES = [ctypes.c_int] * 6
# tensor cores: 64 query rows a block of 128 threads; CUDA cores: 64 query
# rows and 32-position kv tiles a block of 256 threads
TC_ROWS, TC_THREADS, F32_ROWS, F32_KV, F32_THREADS = 64, 128, 64, 32, 256


def launch_plan(b: int, h: int, kh: int, s: int, d: int, dtype: int):
    """The forward's one launch: on the tensor cores a block per (head,
    row, TC_ROWS positions) with the q tile and a four-stage kv ring in
    shared memory; on the CUDA cores a block per (F32_ROWS positions,
    head, row) with padded q, k, v and score tiles. The kernel's whole
    shared memory is opted in either way."""
    if b <= 0 or h <= 0 or s <= 0:
        return ()
    if dtype == 1:
        return (checks.Launch(
            f"tc::flash_attention_kernel<{d}>",
            (h, b, checks.cdiv(s, TC_ROWS)), (TC_THREADS, 1, 1),
            smem=(TC_ROWS + 4 * TC_ROWS) * d * 2, optin=True,
            tiles=((0, 1, h, False), (1, 1, b, False),
                   (2, TC_ROWS, s, False))),)
    smem = (F32_ROWS * (d + 1) + F32_KV * (d + 1) + F32_KV * d
            + F32_ROWS * (F32_KV + 1)) * 4
    return (checks.Launch(
        f"f32::flash_attention_kernel<{d}>",
        (checks.cdiv(s, F32_ROWS), h, b), (F32_THREADS, 1, 1), smem=smem,
        optin=True, tiles=((0, F32_ROWS, s, False), (1, 1, h, False),
                           (2, 1, b, False))),)


def bwd_launch_plan(b: int, h: int, kh: int, s: int, d: int, dtype: int):
    """The backward's two launches over BWD_TILE-position tiles, dq then
    dkv: on the tensor cores a block per (query head, row, tile) of
    TC_THREADS threads and per (kv head, row, tile) of two warpgroups; on
    the CUDA cores a block per (tile, row x head) of F32_THREADS threads,
    their grids' y being B x H and B x K. Each launch's whole shared
    memory is opted in."""
    t = checks.cdiv(s, BWD_TILE)
    if dtype == 1:
        return (
            checks.Launch(f"tc::dq_kernel<{d}>", (h, b, t),
                          (TC_THREADS, 1, 1),
                          smem=6 * BWD_TILE * d * 2 + BWD_TILE * 4,
                          optin=True, tiles=((0, 1, h, False),
                                             (1, 1, b, False),
                                             (2, BWD_TILE, s, False))),
            checks.Launch(f"tc::dkv_kernel<{d}>", (kh, b, t),
                          (2 * TC_THREADS, 1, 1),
                          smem=10 * BWD_TILE * d * 2 + 8 * BWD_TILE * 4,
                          optin=True, tiles=((0, 1, kh, False),
                                             (1, 1, b, False),
                                             (2, BWD_TILE, s, False))))

    def smem(scores):
        return (4 * BWD_TILE * (d + 1) + scores * BWD_TILE * (BWD_TILE + 1)
                + 2 * BWD_TILE) * 4

    return (
        checks.Launch(f"f32::dq_kernel<float, {d}>", (t, b * h, 1),
                      (F32_THREADS, 1, 1), smem=smem(1), optin=True,
                      tiles=((0, BWD_TILE, s, False),
                             (1, 1, b * h, False))),
        checks.Launch(f"f32::dkv_kernel<float, {d}>", (t, b * kh, 1),
                      (F32_THREADS, 1, 1), smem=smem(2), optin=True,
                      tiles=((0, BWD_TILE, s, False),
                             (1, 1, b * kh, False))))


def plan_c_args(b: int, h: int, kh: int, s: int, d: int, dtype: int):
    """The C plans' arguments for :func:`launch_plan`'s (both plans')."""
    return (b, h, kh, s, d, dtype)


def _shapes(q: torch.Tensor, k: torch.Tensor, kernel: str):
    """(B, H, K, S, D) of q ``[B, H, S, D]`` and k ``[B, K, S, D]``; raises
    on a layout the kernels do not take."""
    checks.require_cuda(q, kernel)
    if q.ndim != 4 or k.ndim != 4:
        raise ValueError("q must be [B, H, S, D] and k, v [B, K, S, D]")
    b, h, s, d = q.shape
    kh = k.shape[1]
    if kh == 0 or h % kh:
        raise ValueError(f"H={h} is not a multiple of K={kh}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    return b, h, kh, s, d


def _check_strided(q: torch.Tensor, named, shapes) -> None:
    """Each of ``named`` [(name, tensor)] has q's dtype and device, its
    shape from ``shapes``, and a contiguous last dimension."""
    for (name, t), shape in zip(named, shapes):
        checks.check(t, name, q.dtype, shape, q.device, contiguous=False)
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s last dimension must be contiguous")


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        out = _flash_attention(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        if dout.device.type != "meta" and not checks.has_16_byte_rows(dout):
            # a fresh contiguous copy, whose rows start on 16 bytes (a
            # shape-only run on `meta` has no addresses to align)
            dout = dout.clone(memory_format=torch.contiguous_format)
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout,
                                         causal=ctx.causal)
        return dq, dk, dv, None


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

    Differentiable: with autograd on and an input that requires a
    gradient, the backward runs :func:`flash_attention_bwd`.
    """
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal)
    return _flash_attention(q, k, v, causal)


def _flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     causal: bool) -> torch.Tensor:
    if checks.runs_plain(q):
        return checks.run_plain(KERNEL, flash_attention_plain, q, k, v,
                                causal=causal)
    b, h, kh, s, d = _shapes(q, k, KERNEL)
    code = checks.dtype_code(q, "q")
    _check_strided(q, (("q", q), ("k", k), ("v", v)),
                   ((b, h, s, d), (b, kh, s, d), (b, kh, s, d)))
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            checks.require_16_byte_rows(t, name)
    out = torch.empty_like(q)  # q's strides, or contiguous: aligned either way
    strides = (ctypes.c_int64 * 12)(*(
        st for t in (q, k, v, out) for st in t.stride()[:3]))
    checks.launching(KERNEL, b=b, h=h, kh=kh, s=s, d=d, dtype=code)
    fn = checks.launcher(KERNEL, "flash_attention_launch", _ARGTYPES)
    checks.run(KERNEL, fn, q.device, q.data_ptr(), k.data_ptr(),
               v.data_ptr(), out.data_ptr(), ctypes.addressof(strides),
               b, h, kh, s, d, 1.0 / math.sqrt(d), int(causal), code)
    launch_counts[KERNEL] += 1
    return out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor, *,
                        causal: bool = True):
    """The gradient of :func:`flash_attention` at q ``[B, H, S, D]``, k, v
    ``[B, K, S, D]``, its output ``out`` and the output's gradient
    ``dout`` (both ``[B, H, S, D]``): (dq, dk, dv) in the inputs' dtype,
    the query heads of each group summed into their kv head.

    On the card: two launches (dq with each row's logsumexp recomputed from
    q and k and delta = rowsum(dout * out), then dk and dv a key tile at a
    time), no float atomics, so the same inputs give the same gradient
    bitwise; bfloat16 on the tensor cores, float32 on the CUDA cores; any
    S, causal or not, D one of 16, 32, 64, 128. The inputs are read through
    their strides, as the forward reads them: strided views go in without
    copies (the last dimension must be contiguous); dq, dk and dv come back
    contiguous. bfloat16 inputs are copied as 16-byte rows, so, as for the
    forward, every base pointer must be 16-byte aligned and every batch,
    head and position stride a multiple of 8 elements, or the wrapper
    raises ``ValueError``. On the CPU, the plain backward.
    """
    if checks.runs_plain(q):
        return checks.run_plain(BWD_KERNEL, flash_attention_bwd_plain, q, k,
                                v, out, dout, causal=causal)
    b, h, kh, s, d = _shapes(q, k, BWD_KERNEL)
    code = checks.dtype_code(q, "q")
    _check_strided(q, (("q", q), ("k", k), ("v", v), ("out", out),
                       ("dout", dout)),
                   ((b, h, s, d), (b, kh, s, d), (b, kh, s, d),
                    (b, h, s, d), (b, h, s, d)))
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v), ("out", out),
                        ("dout", dout)):
            checks.require_16_byte_rows(t, name)
    dq = torch.empty((b, h, s, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, kh, s, d), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    s_pad = -(-s // BWD_TILE) * BWD_TILE
    lse = torch.empty((b, h, s_pad), dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    strides = (ctypes.c_int64 * 15)(*(
        st for t in (q, k, v, out, dout) for st in t.stride()[:3]))
    checks.launching(BWD_KERNEL, b=b, h=h, kh=kh, s=s, d=d, dtype=code)
    fn = checks.launcher(BWD_KERNEL, "flash_attention_bwd_launch",
                         _BWD_ARGTYPES)
    checks.run(BWD_KERNEL, fn, q.device, q.data_ptr(), k.data_ptr(),
               v.data_ptr(), out.data_ptr(), dout.data_ptr(), dq.data_ptr(),
               dk.data_ptr(), dv.data_ptr(), lse.data_ptr(),
               delta.data_ptr(), ctypes.addressof(strides), b, h, kh, s, d,
               1.0 / math.sqrt(d), int(causal), code)
    launch_counts[BWD_KERNEL] += BWD_LAUNCHES
    return dq, dk, dv
