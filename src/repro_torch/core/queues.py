"""FIFO service queues and the scheduler's snapshot view (paper Sec. III).

Each model is backed by a dedicated FIFO queue. Requests arrive continuously
and are enqueued regardless of accelerator state; the scheduler sees a
*snapshot* of per-task queueing times at each scheduling round.
"""

from __future__ import annotations

from collections import deque
from typing import Iterable, List, Optional, Sequence

import numpy as np

from repro_torch.core.request import Request


class ServiceQueue:
    """FIFO queue for one model; O(1) enqueue/dequeue, O(n) snapshot."""

    __slots__ = ("model", "_q", "_n_deadline")

    def __init__(self, model: int):
        self.model = model
        self._q: deque = deque()
        self._n_deadline = 0  # queued requests carrying a per-request deadline

    def __len__(self) -> int:
        return len(self._q)

    def push(self, req: Request) -> None:
        self._q.append(req)
        if req.deadline is not None:
            self._n_deadline += 1

    def pop_batch(self, batch_size: int) -> List[Request]:
        """Dequeue the ``batch_size`` oldest requests (FIFO)."""
        n = min(batch_size, len(self._q))
        out = [self._q.popleft() for _ in range(n)]
        if self._n_deadline:
            self._n_deadline -= sum(1 for r in out if r.deadline is not None)
        return out

    @property
    def has_deadlines(self) -> bool:
        return self._n_deadline > 0

    def arrivals(self) -> np.ndarray:
        """``[n]`` arrival times, oldest first."""
        return np.fromiter(
            (r.arrival for r in self._q), dtype=np.float64, count=len(self._q)
        )

    def waits(self, now: float) -> np.ndarray:
        """``[n]`` queueing times at ``now``, oldest (largest wait) first."""
        return now - self.arrivals()

    def deadlines(self) -> np.ndarray:
        """``[n]`` per-task deadlines, ``NaN`` where the request has none
        (callers substitute the global SLO; FIFO order matches ``waits``)."""
        return np.fromiter(
            (np.nan if r.deadline is None else r.deadline for r in self._q),
            dtype=np.float64,
            count=len(self._q),
        )

    def peek_oldest(self) -> Optional[Request]:
        return self._q[0] if self._q else None

    def pending(self) -> List[Request]:
        """Queued requests, FIFO order (read-only copy; telemetry uses this
        for residual-span accounting at end of run)."""
        return list(self._q)


class QueueSnapshot:
    """Immutable per-round view consumed by schedulers.

    Attributes:
      now:    snapshot wall-clock time (seconds).
      waits:  list of M float64 arrays, FIFO order (index 0 = oldest task,
              i.e. the maximum queueing time ``w_max`` of that queue).
      deadlines: ``None`` when every queued task uses the global SLO (the
              common case — schedulers then take a scalar-tau fast path that
              is bitwise-identical to the pre-deadline code), else a list of
              M float64 arrays aligned with ``waits`` where ``NaN`` marks
              "use the global SLO".
    """

    __slots__ = ("now", "waits", "deadlines", "_padded_cache", "_tau_cache")

    def __init__(
        self,
        now: float,
        waits: Sequence[np.ndarray],
        deadlines: Optional[Sequence[np.ndarray]] = None,
    ):
        self.now = now
        self.waits = list(waits)
        self.deadlines = list(deadlines) if deadlines is not None else None
        self._padded_cache = None  # lazily built default padded() view
        self._tau_cache = None     # (default_tau, [M, maxQ] matrix)

    @property
    def num_models(self) -> int:
        return len(self.waits)

    def qlen(self, m: int) -> int:
        return len(self.waits[m])

    def qlens(self) -> List[int]:
        return [len(w) for w in self.waits]

    def w_max(self, m: int) -> float:
        return float(self.waits[m][0]) if len(self.waits[m]) else 0.0

    def nonempty(self) -> List[int]:
        return [m for m, w in enumerate(self.waits) if len(w)]

    def total_tasks(self) -> int:
        return sum(len(w) for w in self.waits)

    # -- per-task deadlines (heterogeneous-SLO workloads) --------------------

    @property
    def has_deadlines(self) -> bool:
        return self.deadlines is not None

    def taus(self, m: int, default: float) -> np.ndarray:
        """``[n]`` effective per-task deadlines for queue ``m`` (FIFO order):
        the request's own deadline where set, ``default`` otherwise."""
        if self.deadlines is None:
            return np.full(len(self.waits[m]), default)
        d = self.deadlines[m]
        return np.where(np.isnan(d), default, d)

    def oldest_tau(self, m: int, default: float) -> float:
        """Effective deadline of queue ``m``'s oldest task (Eq. 6 uses the
        head-of-line task's budget; ``default`` for empty queues)."""
        if self.deadlines is None or not len(self.deadlines[m]):
            return default
        d = float(self.deadlines[m][0])
        return default if np.isnan(d) else d

    def padded_taus(self, default: float) -> np.ndarray:
        """``[M, maxQ]`` effective-deadline matrix aligned with ``padded()``
        (``default`` at padded slots; cached per ``default``)."""
        if self._tau_cache is not None and self._tau_cache[0] == default:
            return self._tau_cache[1]
        _, mask = self.padded()
        tau = np.full(mask.shape, default, dtype=np.float64)
        if self.deadlines is not None:
            cap = mask.shape[1]
            for m, d in enumerate(self.deadlines):
                n = min(len(d), cap)
                if n:
                    tau[m, :n] = np.where(np.isnan(d[:n]), default, d[:n])
        self._tau_cache = (default, tau)
        return tau

    def padded(
        self, max_q: Optional[int] = None, dtype=np.float64
    ) -> "tuple[np.ndarray, np.ndarray]":
        """Padded ``([M, maxQ] waits, [M, maxQ] mask)`` for vectorised scoring.

        The default view (``max_q=None``, float64) is built once and reused:
        the snapshot is immutable, and the lattice scheduler, the vectorised
        greedy, and A/B comparisons all score off the same matrices.
        """
        if max_q is None and dtype is np.float64:
            if self._padded_cache is None:
                self._padded_cache = self._build_padded(None, np.float64)
            return self._padded_cache
        return self._build_padded(max_q, dtype)

    def _build_padded(
        self, max_q: Optional[int], dtype
    ) -> "tuple[np.ndarray, np.ndarray]":
        m_count = len(self.waits)
        cap = max_q or max((len(w) for w in self.waits), default=0)
        cap = max(cap, 1)
        w = np.zeros((m_count, cap), dtype=dtype)
        mask = np.zeros((m_count, cap), dtype=dtype)
        for m, wq in enumerate(self.waits):
            n = min(len(wq), cap)
            w[m, :n] = wq[:n]
            mask[m, :n] = 1.0
        return w, mask

    @staticmethod
    def take(queues: Iterable[ServiceQueue], now: float) -> "QueueSnapshot":
        qs = list(queues)
        deadlines = None
        if any(q.has_deadlines for q in qs):
            deadlines = [q.deadlines() for q in qs]
        return QueueSnapshot(now, [q.waits(now) for q in qs], deadlines)
