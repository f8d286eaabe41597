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
    fn = checks.launcher(KERNEL, "decode_attention_launch", _ARGTYPES)
    checks.run(KERNEL, fn, q.device, q.data_ptr(), k.data_ptr(),
               v.data_ptr(), lengths.data_ptr(), out.data_ptr(),
               ctypes.addressof(strides), b, h, kh, s, d, chunk, n_chunks,
               1.0 / math.sqrt(d), code)
    launch_counts[KERNEL] += 1
    return out
