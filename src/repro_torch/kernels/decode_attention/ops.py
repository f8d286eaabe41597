"""Public wrapper for the decode-attention kernel
(``csrc/decode_attention.cu``).

The shape checks hold on both devices. Then CPU tensors go to the plain
version in ``ref.py``; CUDA tensors launch the CUDA kernel, or the wrapper
raises. There is no fallback between the two.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import checks, launch_counts
from repro_torch.kernels.decode_attention.ref import decode_attention_plain

KERNEL = "decode_attention"
HEAD_DIMS = (16, 32, 64, 128)
# A block takes a chunk of a row's cache for one kv head; the chunks of one
# (row, kv head) are one thread-block cluster of at most MAX_CLUSTER blocks
# (kMaxCluster in the source), each a whole number of TILE positions (the
# float32 kernel's tile; the bfloat16 kernel's 16-position slices divide
# it). A cache of at most MIN_CHUNK positions (the served S = 160) goes to
# one block whole: a cluster's fold costs more than its blocks save there.
TILE, MAX_CLUSTER, MIN_CHUNK = 32, 8, 256
# Blocks to aim for: one per SM of an H100's 132 (the bfloat16 kernel's
# 128 KB ring at D = 128 leaves room for one).
TARGET_BLOCKS = 132
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]

# The launch plan (``decode_attention_plan`` in the source): entries by head
# dim, tc:: (bfloat16 on the tensor cores) then f32::, and the kernels'
# shapes: threads, query heads a block, and the shared memory they take.
ENTRIES = tuple(f"{ns}::decode_attention_kernel<{d}>"
                for ns in ("tc", "f32") for d in HEAD_DIMS)
PLAN_ARGTYPES = [ctypes.c_int] * 8
TC_THREADS, TC_HEADS, F32_THREADS, F32_HEADS = 256, 8, 128, 4


def _smem(d: int, dtype: int) -> int:
    """The kernel's dynamic shared memory at head dim ``d`` (``Shape<D>``
    in the source): the K/V ring (tensor cores: 8 warps' rings of 16-row
    slices, 2-8 stages in about 104 KB; CUDA cores: 32-row stages, up to 8
    in about 96 KB), then the block's scratch."""
    if dtype == 1:
        slice_elems = 16 * d
        stages = min(max(104 * 1024 // (8 * 2 * slice_elems * 2), 2), 8)
        ring = 8 * stages * 2 * slice_elems
        return ((ring + 8 * TC_HEADS * 24) * 2
                + (TC_HEADS * d + 2 * TC_HEADS + 2 * MAX_CLUSTER * TC_HEADS)
                * 4)
    stage = 2 * TILE * d
    ring = min(96 * 1024 // (stage * 4), 8) * stage
    return (ring + F32_HEADS * d + F32_HEADS * TILE + 3 * F32_HEADS
            + 2 * MAX_CLUSTER * F32_HEADS) * 4


def launch_plan(b: int, h: int, kh: int, s: int, d: int, dtype: int):
    """The one launch of :func:`split`'s plan: a block per (chunk, kv head
    x head group, row), a (row, kv head, head group)'s chunks one cluster,
    the kernel's whole shared memory opted in."""
    if b <= 0 or h <= 0:
        return ()
    chunk, n = split(b, kh, s)
    heads = TC_HEADS if dtype == 1 else F32_HEADS
    groups = kh * checks.cdiv(h // kh, heads)
    return (checks.Launch(
        ENTRIES[(0 if dtype == 1 else 4) + HEAD_DIMS.index(d)],
        (n, groups, b), (TC_THREADS if dtype == 1 else F32_THREADS, 1, 1),
        smem=_smem(d, dtype), optin=True, cluster=n,
        tiles=((0, chunk, s, False), (1, 1, groups, False),
               (2, 1, b, False)),
        index32=(("lengths", b),)),)


def plan_c_args(b: int, h: int, kh: int, s: int, d: int, dtype: int):
    """``decode_attention_plan``'s arguments for :func:`launch_plan`'s."""
    chunk, n = split(b, kh, s)
    return (b, h, kh, s, d, chunk, n, dtype)


def split(b: int, kh: int, s: int):
    """The launch plan, (chunk, number of chunks): one launch whose grid
    is (chunks, kv heads x head groups, B), each (row, kv head, head
    group)'s chunks one cluster. As many chunks as fit TARGET_BLOCKS over
    the B x K (row, kv head) pairs, at most MAX_CLUSTER, and none shorter
    than MIN_CHUNK where S allows; chunks are whole TILEs, chunk * chunks
    >= S, and no chunk lies wholly past S."""
    n = max(1, min(MAX_CLUSTER, TARGET_BLOCKS // max(b * kh, 1),
                   -(-s // MIN_CHUNK)))
    chunk = -(-max(-(-s // n), 1) // TILE) * TILE
    return chunk, max(-(-s // chunk), 1)


def _check_shapes(q, k, v, lengths) -> None:
    if q.ndim != 3 or k.ndim != 4:
        raise ValueError("q must be [B, H, D] and k, v [B, K, S, D]")
    b, h, d = q.shape
    kh, s = k.shape[1], k.shape[2]
    if kh == 0 or h % kh:
        raise ValueError(f"H={h} is not a multiple of K={kh}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    for name, t in (("k", k), ("v", v)):
        if tuple(t.shape) != (b, kh, s, d):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{(b, kh, s, d)}")
    if tuple(lengths.shape) != (b,) or lengths.dtype != torch.int32:
        raise ValueError(f"lengths must be int32 [{b}], got "
                         f"{lengths.dtype} {tuple(lengths.shape)}")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """One-token KV-cache attention: q ``[B, H, D]``; k, v ``[B, K, S, D]``
    with H % K == 0; lengths ``[B]`` int32, the valid cache prefix of each
    row (clamped to S; callers pass lengths >= 1, see ``ref.py`` for 0).
    Scale 1/sqrt(D), float32 softmax; output ``[B, H, D]`` in q's dtype.

    On the card the tensors may be strided views (only the last dimension
    must be contiguous, rows 16-byte aligned), so the model's ``[B, 1, H,
    D]`` activations and ``[B, Smax, K, D]`` cache go in without copies.
    D is one of 16, 32, 64, 128; any S.
    """
    _check_shapes(q, k, v, lengths)
    if checks.runs_plain(q):
        return checks.run_plain(KERNEL, decode_attention_plain, q, k, v,
                                lengths)
    checks.require_cuda(q, KERNEL)
    b, h, d = q.shape
    kh, s = k.shape[1], k.shape[2]
    code = checks.dtype_code(q, "q")
    for name, t in (("q", q), ("k", k), ("v", v)):
        checks.check(t, name, q.dtype, t.shape, q.device, contiguous=False)
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s last dimension must be contiguous")
        if t.data_ptr() % 16 or any(
                st * t.element_size() % 16 for st in t.stride()[:-1]):
            raise ValueError(f"{name}'s rows must be 16-byte aligned")
    checks.check(lengths, "lengths", torch.int32, (b,), q.device)
    chunk, n_chunks = split(b, kh, s)
    out = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_int64 * 8)(q.stride(0), q.stride(1), *k.stride()[:3],
                                   *v.stride()[:3])
    checks.launching(KERNEL, b=b, h=h, kh=kh, s=s, d=d, dtype=code)
    fn = checks.launcher(KERNEL, "decode_attention_launch", _ARGTYPES)
    checks.run(KERNEL, fn, q.device, q.data_ptr(), k.data_ptr(),
               v.data_ptr(), lengths.data_ptr(), out.data_ptr(),
               ctypes.addressof(strides), b, h, kh, s, d, chunk, n_chunks,
               1.0 / math.sqrt(d), code)
    launch_counts[KERNEL] += 1
    return out
