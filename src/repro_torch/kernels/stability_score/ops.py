"""Public wrapper for the stability-score kernel (``csrc/stability_score.cu``).

CPU tensors go to the plain version in ``ref.py``; CUDA tensors launch the
CUDA kernel, or the wrapper raises. There is no fallback between the two.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.urgency import DEFAULT_CLIP, TauLike
from repro_torch.kernels import checks, launch_counts
from repro_torch.kernels.stability_score.ref import stability_scores_plain

KERNEL = "stability_score"
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_float] + [ctypes.c_void_p] * 3 + [
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
    ctypes.c_void_p, ctypes.c_void_p]


def stability_scores(w: torch.Tensor, mask: torch.Tensor,
                     cand_latency: torch.Tensor, cand_batch: torch.Tensor,
                     cand_queue=None, *, tau: TauLike,
                     clip: float = DEFAULT_CLIP) -> torch.Tensor:
    """Score a flattened candidate lattice in one launch (Eq. 3-7).

    w, mask ``[M, Q]`` float32 (FIFO-sorted waits + validity);
    cand_latency ``[N]`` (downcast to float32 here, as the reference's
    wrapper does); cand_batch ``[N]``; cand_queue ``[N]`` maps each
    candidate to the queue it serves (``None``: the greedy layout, N == M).
    ``tau`` is the scalar SLO, passed to the kernel as a float, or an
    ``[M, Q]`` per-task deadline matrix; ``clip`` a scalar. Returns ``[N]``
    float32 scores on w's device.
    """
    if w.device.type == "cpu":
        return stability_scores_plain(w, mask, cand_latency, cand_batch,
                                      cand_queue, tau=tau, clip=clip)
    checks.require_cuda(w, "stability_scores")
    device = w.device
    if w.ndim != 2:
        raise ValueError(f"w must be [M, Q], got shape {tuple(w.shape)}")
    m, q = w.shape
    if cand_latency.ndim != 1:
        raise ValueError("cand_latency must be [N]")
    n = cand_latency.shape[0]
    lat = cand_latency.to(torch.float32)
    batch = cand_batch.to(torch.int32)
    checks.check(w, "w", torch.float32, (m, q), device)
    checks.check(mask, "mask", torch.float32, (m, q), device)
    checks.check(lat, "cand_latency", torch.float32, (n,), device)
    checks.check(batch, "cand_batch", torch.int32, (n,), device)
    if isinstance(tau, torch.Tensor) and tau.ndim == 2:
        checks.check(tau, "tau", torch.float32, (m, q), device)
        tau_ptr, tau_scalar = tau.data_ptr(), 0.0
    else:
        tau_ptr, tau_scalar = None, float(tau)
    if cand_queue is None:
        if n != m:
            raise ValueError(f"cand_queue=None needs N == M, got N={n}, M={m}")
        queue_ptr = None
    else:
        queue = cand_queue.to(torch.int32)
        checks.check(queue, "cand_queue", torch.int32, (n,), device)
        queue_ptr = queue.data_ptr()
    out = torch.empty(n, dtype=torch.float32, device=device)
    launch(device, w.data_ptr(), mask.data_ptr(), tau_ptr, tau_scalar,
           lat.data_ptr(), batch.data_ptr(), queue_ptr, n, m, q, float(clip),
           out.data_ptr())
    return out


def launch(device: torch.device, w_ptr: int, mask_ptr: int,
           tau_ptr: Optional[int], tau_scalar: float, lat_ptr: int,
           batch_ptr: int, queue_ptr: Optional[int], n: int, m: int, q: int,
           clip: float, out_ptr: int) -> None:
    """Launch the kernel on device addresses, unchecked: float32 ``w``,
    ``mask`` and (unless ``tau_ptr`` is None, which selects ``tau_scalar``)
    ``tau`` of ``[M, Q]``, float32 latencies, int32 batches and (unless
    None: the greedy layout) int32 queues of ``[N]``, a float32 ``[N]``
    output. :func:`stability_scores` checks its tensors and calls this; the
    ``cuda`` scoring backend, which packs these arrays itself, calls it
    directly."""
    fn = checks.launcher(KERNEL, "stability_score_launch", _ARGTYPES)
    checks.run(KERNEL, fn, device, w_ptr, mask_ptr, tau_ptr, tau_scalar,
               lat_ptr, batch_ptr, queue_ptr, n, m, q, clip, out_ptr)
    launch_counts[KERNEL] += 1
