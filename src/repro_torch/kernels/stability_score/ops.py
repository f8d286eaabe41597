"""Public wrapper for the stability-score kernel (``csrc/stability_score.cu``).

CPU tensors go to the plain version in ``ref.py``; CUDA tensors launch the
CUDA kernel, or the wrapper raises. There is no fallback between the two.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.urgency import DEFAULT_CLIP, TauLike
from repro_torch.kernels import build, launch_counts
from repro_torch.kernels.stability_score.ref import stability_scores_plain

KERNEL = "stability_score"


def _launcher():
    fn = build.load(KERNEL).stability_score_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def stability_scores(w: torch.Tensor, mask: torch.Tensor,
                     cand_latency: torch.Tensor, cand_batch: torch.Tensor,
                     cand_queue=None, *, tau: TauLike,
                     clip: float = DEFAULT_CLIP) -> torch.Tensor:
    """Score a flattened candidate lattice in one launch (Eq. 3-7).

    w, mask ``[M, Q]`` float32 (FIFO-sorted waits + validity);
    cand_latency ``[N]`` (downcast to float32 here, as the reference's
    wrapper does); cand_batch ``[N]``; cand_queue ``[N]`` maps each
    candidate to the queue it serves (``None``: the greedy layout, N == M).
    ``tau`` is the scalar SLO or an ``[M, Q]`` per-task deadline matrix;
    ``clip`` a scalar. Returns ``[N]`` float32 scores on w's device.
    """
    if w.device.type == "cpu":
        return stability_scores_plain(w, mask, cand_latency, cand_batch,
                                      cand_queue, tau=tau, clip=clip)
    if w.device.type != "cuda":
        raise ValueError(f"stability_scores runs on cpu or cuda, not "
                         f"{w.device}")
    device = w.device
    if w.ndim != 2:
        raise ValueError(f"w must be [M, Q], got shape {tuple(w.shape)}")
    m, q = w.shape
    if cand_latency.ndim != 1:
        raise ValueError("cand_latency must be [N]")
    n = cand_latency.shape[0]
    lat = cand_latency.to(torch.float32)
    batch = cand_batch.to(torch.int32)
    if isinstance(tau, torch.Tensor) and tau.ndim == 2:
        tau_mat = tau
    else:
        # scalar tau -> filled [M, Q] matrix, as the Pallas wrapper does
        tau_mat = torch.full((m, q), float(tau), dtype=torch.float32,
                             device=device)
    _check(w, "w", torch.float32, (m, q), device)
    _check(mask, "mask", torch.float32, (m, q), device)
    _check(tau_mat, "tau", torch.float32, (m, q), device)
    _check(lat, "cand_latency", torch.float32, (n,), device)
    _check(batch, "cand_batch", torch.int32, (n,), device)
    if cand_queue is None:
        if n != m:
            raise ValueError(f"cand_queue=None needs N == M, got N={n}, M={m}")
        queue_ptr = None
    else:
        queue = cand_queue.to(torch.int32)
        _check(queue, "cand_queue", torch.int32, (n,), device)
        queue_ptr = queue.data_ptr()
    out = torch.empty(n, dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _launcher()(
            w.data_ptr(), mask.data_ptr(), tau_mat.data_ptr(), lat.data_ptr(),
            batch.data_ptr(), queue_ptr, n, m, q, float(clip),
            out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"stability_score launch failed: CUDA error {err}")
    launch_counts[KERNEL] += 1
    return out
