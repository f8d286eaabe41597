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
    (Eq. 4-7). Schedulers hold one instance; only the ``cuda`` backend keeps
    state, its staging buffers.
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

    A round (:meth:`score`) is four steps, each a method so that a caller
    can time them apart: :meth:`pack` writes w, mask, the tau matrix (only
    for per-task deadlines: a scalar SLO goes to the kernel as a float),
    the latencies, batches and queues into one staging buffer;
    :meth:`upload` copies them to the card in one non-blocking copy;
    :meth:`launch` runs the kernel, which writes the scores after the
    inputs in the card's buffer; :meth:`fetch` copies the scores back in one
    copy that synchronises the stream once, and returns a copy of them.

    The staging buffer is pinned, and it and its card twin are held by the
    backend and grown by doubling. Reusing them is safe because every round
    ends in that synchronise: no copy or kernel of a round still reads or
    writes them when the next round packs (the upload, the kernel and the
    fetch are queued on one stream, in that order).

    Given ``device="cpu"`` nothing is pinned or copied: the same packing
    feeds the kernel's plain version (the wrapper dispatches on the
    tensors' device).
    """

    name = "cuda"

    def __init__(self, device: Optional[str] = None):
        self.device = resolve_device(device)
        self._on_card = self.device.type == "cuda"
        self._host = self._host_np = self._dev = None

    def pack(self, w, mask, cand_latency, cand_batch, cand_queue, tau):
        """Write one round's inputs into the staging buffer: float32
        ``w | mask | tau (per-task only) | latency``, then int32
        ``batch | queue``; the scores go after them. Returns the layout
        ``(m, q, n, per_task)``."""
        m, q = w.shape
        n = len(cand_queue)
        mq = m * q
        per_task = getattr(tau, "ndim", 0) == 2  # np.ndim costs a us
        lat_at = (3 if per_task else 2) * mq
        if self._host is None or lat_at + 4 * n > self._host.numel():
            self._grow(lat_at + 4 * n)
        buf = self._host_np
        buf[:mq] = w.reshape(-1)
        buf[mq:2 * mq] = mask.reshape(-1)
        if per_task:
            buf[2 * mq:lat_at] = np.asarray(tau).reshape(-1)
        buf[lat_at:lat_at + n] = cand_latency
        ints = buf[lat_at + n:lat_at + 3 * n].view(np.int32)
        ints[:n] = cand_batch
        ints[n:] = cand_queue
        return m, q, n, per_task

    def _grow(self, size: int) -> None:
        size = max(size, 1024, 0 if self._host is None
                   else 2 * self._host.numel())
        self._host = torch.empty(size, dtype=torch.float32,
                                 pin_memory=self._on_card)
        self._host_np = self._host.numpy()
        self._dev = (torch.empty(size, dtype=torch.float32,
                                 device=self.device)
                     if self._on_card else self._host)

    @staticmethod
    def _scores_at(layout) -> int:
        """Where the scores start: after the floats and the two int
        arrays."""
        m, q, n, per_task = layout
        return (3 if per_task else 2) * m * q + 3 * n

    def upload(self, layout) -> None:
        """One non-blocking host-to-card copy of the packed inputs."""
        if self._on_card:
            size = self._scores_at(layout)
            self._dev[:size].copy_(self._host[:size], non_blocking=True)

    def launch(self, layout, tau, clip=DEFAULT_CLIP) -> None:
        """The kernel over the uploaded inputs, into the scores' slots."""
        from repro_torch.kernels.stability_score import ops

        m, q, n, per_task = layout
        mq = m * q
        lat_at, out_at = (3 if per_task else 2) * mq, self._scores_at(layout)
        clip = float(np.float32(clip))
        tau_scalar = 0.0 if per_task else float(np.float32(tau))
        buf = self._dev
        if self._on_card:
            base, f32 = buf.data_ptr(), 4
            ops.launch(self.device, base, base + mq * f32,
                       base + 2 * mq * f32 if per_task else None, tau_scalar,
                       base + lat_at * f32, base + (lat_at + n) * f32,
                       base + (lat_at + 2 * n) * f32, n, m, q, clip,
                       base + out_at * f32)
            return
        ints = buf[lat_at + n:out_at].view(torch.int32)
        buf[out_at:out_at + n] = ops.stability_scores(
            buf[:mq].view(m, q), buf[mq:2 * mq].view(m, q),
            buf[lat_at:lat_at + n], ints[:n], ints[n:],
            tau=buf[2 * mq:lat_at].view(m, q) if per_task else tau_scalar,
            clip=clip)

    def fetch(self, layout) -> np.ndarray:
        """One copy of the scores into the pinned host buffer, which waits
        for the current stream, and a copy of them that the next round
        cannot overwrite. A blocking ``copy_`` to the host is the copy
        enqueued on the current stream, then one synchronise of that stream,
        in one call (a separate synchronise would cost a second call and a
        ``Stream`` object)."""
        at, n = self._scores_at(layout), layout[2]
        if self._on_card:
            self._host[at:at + n].copy_(self._dev[at:at + n])
        return self._host_np[at:at + n].copy()

    def score(self, w, mask, cand_latency, cand_batch, cand_queue, tau,
              clip=DEFAULT_CLIP):
        layout = self.pack(w, mask, cand_latency, cand_batch, cand_queue, tau)
        self.upload(layout)
        self.launch(layout, tau, clip)
        return self.fetch(layout)


SCORING_BACKENDS: Dict[str, Type[ScoringBackend]] = {
    "numpy": NumpyScoringBackend,
    "torch": TorchScoringBackend,
    "cuda": CudaScoringBackend,
}


@functools.lru_cache(maxsize=None)
def make_scoring_backend(name: str,
                         device: Optional[str] = None) -> ScoringBackend:
    """Backend factory, cached by (name, device): one instance each (the
    ``cuda`` backend's buffers are reused round after round). ``device`` is
    ignored by ``numpy``."""
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
