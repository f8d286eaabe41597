"""Scoring backends: one Sec. V-C scoring entry point, three engines.

Every Algorithm-1 scheduler reduces each round to the same computation —
score a flattened candidate list against the padded queue state (Eq. 4 +
the Sec. V-C queue-status prediction) and take the argmin. This module
makes that computation a swappable **backend** selected by
``SchedulerConfig.backend``:

  * ``numpy`` — the host-NumPy padded pass (default; float64, op for op the
                reference's, so its scores are bitwise the reference's).
  * ``torch`` — the plain float32 tensor version (the twin of the
                reference's ``jnp`` backend).
  * ``cuda``  — the hand-written CUDA kernel
                ``repro_torch.kernels.stability_score`` (the twin of the
                reference's ``pallas`` backend).

All three accept a scalar SLO **or** an ``[M, maxQ]`` per-task deadline
matrix. The float32 backends match the float64 scores to ~1e-6 relative,
orders of magnitude below the score gaps that separate real candidates, so
decisions agree across backends.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Type, Union

import numpy as np
import torch

from repro_torch.core.urgency import DEFAULT_CLIP, lattice_stability_scores
from repro_torch.device import resolve_device

__all__ = ["ScoringBackend", "SCORING_BACKENDS", "make_scoring_backend"]

TauLike = Union[float, np.ndarray]


class ScoringBackend:
    """Scores a flattened candidate lattice against a padded queue state.

    Candidate ``n`` hypothetically serves the ``cand_batch[n]`` oldest tasks
    of queue ``cand_queue[n]`` for ``cand_latency[n]`` seconds; the backend
    returns the predicted post-decision stability score of each candidate
    (Eq. 4-7). Backends are stateless; schedulers hold one instance.
    """

    name = "base"

    def score(
        self,
        w: np.ndarray,
        mask: np.ndarray,
        cand_latency: np.ndarray,
        cand_batch: np.ndarray,
        cand_queue: np.ndarray,
        tau: TauLike,
        clip: float = DEFAULT_CLIP,
    ) -> np.ndarray:
        """``w``/``mask`` are the ``[M, maxQ]`` float64 padded waits and
        validity mask (``QueueSnapshot.padded``); ``cand_*`` are the ``[N]``
        candidate arrays (``Scheduler.enumerate_candidates``); ``tau`` is
        the scalar SLO or the ``[M, maxQ]`` per-task deadline matrix
        (``QueueSnapshot.padded_taus``). Returns ``[N]`` host scores."""
        raise NotImplementedError


class NumpyScoringBackend(ScoringBackend):
    """Host float64 reference — op for op the reference's numpy backend."""

    name = "numpy"

    def score(self, w, mask, cand_latency, cand_batch, cand_queue, tau,
              clip=DEFAULT_CLIP):
        n = len(cand_queue)
        max_q = w.shape[1]
        tau_b = tau[None, :, :] if np.ndim(tau) == 2 else tau
        shifted = w[None, :, :] + cand_latency[:, None, None]
        urg = np.minimum(
            np.exp(np.minimum(shifted / tau_b - 1.0, np.log(clip))), clip
        ) * mask[None, :, :]
        total = urg.sum(axis=(1, 2))
        pos = np.arange(max_q)[None, :]
        served = (pos < cand_batch[:, None]).astype(np.float64)
        own = urg[np.arange(n), cand_queue, :]
        return total - (own * served).sum(axis=1)


class TorchScoringBackend(ScoringBackend):
    """The plain float32 tensor version on ``device`` (the card unless the
    caller asks for the CPU)."""

    name = "torch"

    def __init__(self, device: Optional[str] = None):
        self.device = resolve_device(device)

    def score(self, w, mask, cand_latency, cand_batch, cand_queue, tau,
              clip=DEFAULT_CLIP):
        dev = self.device

        def put(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

        tau_dev = (put(tau, np.float32) if np.ndim(tau) == 2
                   else float(np.float32(tau)))
        out = lattice_stability_scores(
            put(w, np.float32), put(mask, np.float32),
            put(cand_latency, np.float32), put(cand_batch, np.int64),
            put(cand_queue, np.int64), tau_dev, float(np.float32(clip)))
        return out.cpu().numpy()


class CudaScoringBackend(ScoringBackend):
    """One launch of the CUDA stability-score kernel per round.

    The float inputs travel in one host buffer and the integer inputs in
    another, so a round costs two host-to-device copies, the launch and one
    copy back. Given ``device="cpu"`` the same path runs the kernel's plain
    version (the wrapper dispatches on the tensors' device).
    """

    name = "cuda"

    def __init__(self, device: Optional[str] = None):
        self.device = resolve_device(device)

    def score(self, w, mask, cand_latency, cand_batch, cand_queue, tau,
              clip=DEFAULT_CLIP):
        from repro_torch.kernels.stability_score.ops import stability_scores

        m, q = w.shape
        n = len(cand_queue)
        mq = m * q
        per_task_tau = np.ndim(tau) == 2
        floats = np.empty((3 if per_task_tau else 2) * mq + n, np.float32)
        floats[:mq] = w.ravel()
        floats[mq:2 * mq] = mask.ravel()
        if per_task_tau:
            floats[2 * mq:3 * mq] = np.asarray(tau).ravel()
        floats[-n:] = cand_latency
        ints = np.empty(2 * n, np.int32)
        ints[:n] = cand_batch
        ints[n:] = cand_queue
        f_dev = torch.from_numpy(floats).to(self.device)
        i_dev = torch.from_numpy(ints).to(self.device)
        tau_dev = (f_dev[2 * mq:3 * mq].view(m, q) if per_task_tau
                   else float(np.float32(tau)))
        out = stability_scores(
            f_dev[:mq].view(m, q), f_dev[mq:2 * mq].view(m, q), f_dev[-n:],
            i_dev[:n], i_dev[n:], tau=tau_dev, clip=float(np.float32(clip)))
        return out.cpu().numpy()


SCORING_BACKENDS: Dict[str, Type[ScoringBackend]] = {
    "numpy": NumpyScoringBackend,
    "torch": TorchScoringBackend,
    "cuda": CudaScoringBackend,
}


@functools.lru_cache(maxsize=None)
def make_scoring_backend(name: str,
                         device: Optional[str] = None) -> ScoringBackend:
    """Backend factory, cached by (name, device): backends are stateless
    singletons. ``device`` is ignored by ``numpy``."""
    try:
        cls = SCORING_BACKENDS[name]
    except KeyError:
        raise ValueError(
            f"unknown scoring backend {name!r}; "
            f"available: {sorted(SCORING_BACKENDS)}"
        ) from None
    if cls is NumpyScoringBackend:
        return cls()
    return cls(device)
