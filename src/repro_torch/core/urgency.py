"""Urgency activation and stability score (paper Eq. 3-4).

The urgency of a queued task with queueing time ``w`` under SLO deadline
``tau`` is

    f(w) = min(exp(w / tau - 1), C)                                (Eq. 3)

-- exponential because remaining slack shrinks super-linearly as ``w``
approaches ``tau``; normalised so that ``f(tau) = 1`` for any SLO; clipped
at ``C`` so tasks already far beyond the deadline (``w > tau (1 + ln C)``)
cannot dominate and starve the remaining queues.

The *stability score* of the whole system is the sum of urgencies over all
queued tasks of all models:

    S = sum_m sum_{i in Q_m} f(w_{m,i})                            (Eq. 4)

Two implementations: NumPy float64 (the host scheduler hot path, op for op
the reference's) and float32 torch tensor functions (the twin of the
reference's jnp path, and the plain version the CUDA kernel in
``repro_torch.kernels.stability_score`` is checked against).
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

# Paper: "tasks already far beyond the SLO (e.g. w > tau(1+ln 10) ~ 3.3 tau)"
# => the running example uses C = 10.
DEFAULT_CLIP = 10.0

TauLike = Union[float, torch.Tensor]


# ---------------------------------------------------------------------------
# NumPy host path (used inside the per-round scheduler loop)
# ---------------------------------------------------------------------------

def urgency_np(w: np.ndarray, tau, clip: float = DEFAULT_CLIP) -> np.ndarray:
    """Eq. 3 on a NumPy array of queueing times (seconds).

    ``tau`` is the global SLO scalar, or an array broadcastable against ``w``
    of per-task deadlines (heterogeneous-SLO workloads; everything is
    elementwise so both forms share one code path).

    Implemented as exp(min(w/tau - 1, ln C)) == min(exp(w/tau - 1), C) to
    stay overflow-free for arbitrarily late tasks.
    """
    return np.minimum(np.exp(np.minimum(w / tau - 1.0, np.log(clip))), clip)


def stability_score_np(
    waits: "list[np.ndarray]", tau: float, clip: float = DEFAULT_CLIP
) -> float:
    """Eq. 4 over a list of per-queue queueing-time arrays."""
    total = 0.0
    for w in waits:
        if len(w):
            total += float(urgency_np(np.asarray(w, dtype=np.float64), tau, clip).sum())
    return total


# ---------------------------------------------------------------------------
# float32 torch path (the twin of the reference's jnp functions)
# ---------------------------------------------------------------------------

def _f32(x, like: torch.Tensor) -> torch.Tensor:
    """A scalar or tensor as float32 on ``like``'s device. A scalar becomes
    a 0-dim device tensor, so a division by it is a true division on every
    device (a Python scalar divisor may become a reciprocal multiply)."""
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def urgency(w: torch.Tensor, tau: TauLike,
            clip: float = DEFAULT_CLIP) -> torch.Tensor:
    """Eq. 3 in float32 (exp(min(., ln C)) form: overflow-free for
    arbitrarily late tasks)."""
    clip_t = _f32(clip, w)
    return torch.minimum(
        torch.exp(torch.minimum(w / _f32(tau, w) - 1.0, torch.log(clip_t))),
        clip_t)


def stability_score(w: torch.Tensor, mask: torch.Tensor, tau: TauLike,
                    clip: float = DEFAULT_CLIP) -> torch.Tensor:
    """Eq. 4 over a padded ``[M, maxQ]`` wait matrix with validity mask;
    returns a 0-dim tensor."""
    return torch.sum(urgency(w, tau, clip) * mask)


def lattice_stability_scores(
    w: torch.Tensor,
    mask: torch.Tensor,
    cand_latency: torch.Tensor,
    cand_batch: torch.Tensor,
    cand_queue: torch.Tensor,
    tau: TauLike,
    clip: float = DEFAULT_CLIP,
) -> torch.Tensor:
    """Score a flattened (model, exit, batch) candidate lattice (Eq. 4-7).

    Candidate ``n`` hypothetically serves the ``B_n = cand_batch[n]`` oldest
    tasks of queue ``cand_queue[n]`` for ``L_n = cand_latency[n]`` seconds
    (paper Sec. V-C "Queue Status Prediction"): served tasks are removed and
    every other task waits ``L_n`` longer.

    Args:
      w:            ``[M, maxQ]`` FIFO-sorted (oldest first) wait matrix.
      mask:         ``[M, maxQ]`` validity mask.
      cand_latency: ``[N]`` per-candidate profiled latency ``L_n``.
      cand_batch:   ``[N]`` per-candidate batch size ``B_n`` (int).
      cand_queue:   ``[N]`` queue index each candidate serves.
      tau:          global SLO scalar, or an ``[M, maxQ]`` matrix of
                    per-task deadlines aligned with ``w``.
    Returns:
      ``[N]`` float32 stability score ``S_n``, computed as the total over
      every task minus the served tasks' terms (the reference's order).
    """
    max_q = w.shape[1]
    n = cand_latency.shape[0]
    pos = torch.arange(max_q, device=w.device)[None, :]     # [1, maxQ]
    served = pos < cand_batch[:, None]                       # [N, maxQ]
    tau_t = _f32(tau, w)
    tau_b = tau_t[None, :, :] if tau_t.ndim == 2 else tau_t
    clip_t = _f32(clip, w)

    # f(w + L_n) for all tasks, per candidate: [N, M, maxQ]
    shifted = w[None, :, :] + cand_latency[:, None, None]
    urg = torch.minimum(
        torch.exp(torch.minimum(shifted / tau_b - 1.0, torch.log(clip_t))),
        clip_t,
    ) * mask[None, :, :]

    total = torch.sum(urg, dim=(1, 2))                       # [N]
    own = urg[torch.arange(n, device=w.device), cand_queue.long(), :]
    removed = torch.sum(own * served, dim=1)
    return total - removed


def candidate_stability_scores(
    w: torch.Tensor,
    mask: torch.Tensor,
    cand_latency: torch.Tensor,
    cand_batch: torch.Tensor,
    tau: TauLike,
    clip: float = DEFAULT_CLIP,
) -> torch.Tensor:
    """The Eq. 5/Eq. 6 special case of :func:`lattice_stability_scores`:
    exactly one candidate per queue, candidate ``m`` serving queue ``m``.
    Candidates with empty queues still get a (meaningless) score; callers
    mask them."""
    m_count = w.shape[0]
    return lattice_stability_scores(
        w, mask, cand_latency, cand_batch,
        torch.arange(m_count, device=w.device), tau, clip)
