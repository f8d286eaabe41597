"""Baseline and ablation scheduling policies (paper Sec. VI-A, VI-H).

Baselines:
  * All-Final   -- LQF model selection, always deepest exit, B = min(|Q|, Bmax).
  * All-Early   -- LQF model selection, always shallowest exit.
  * Symphony    -- deferred deadline-driven batching: each queue is dispatched
                   (at the final exit) only once its oldest request approaches
                   the SLO deadline, maximising batch size; queues are
                   scheduled independently of one another.

Ablations (each removes exactly one EdgeServing component):
  * Early-Exit+LQF  -- Eq. 5/6 exit+batch selection, LQF model selection.
  * Early-Exit+EDF  -- Eq. 5/6 exit+batch selection, EDF model selection.
  * All-Final+Deadline-Aware -- stability-score selection, exits pinned final.
  * Ours+bs=1       -- full scheduler with dynamic batching disabled.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.profile import ProfileTable
from repro_torch.core.queues import QueueSnapshot
from repro_torch.core.request import Decision
from repro_torch.core.scheduler import (
    EdgeServingScheduler,
    LatticeEdgeServingScheduler,
    Scheduler,
    SchedulerConfig,
)


class _FixedExitLQF(Scheduler):
    """Longest-queue-first with a pinned exit point (paper's non-adaptive
    baselines). Ties broken toward the queue with the oldest task."""

    _pinned_exit: int = -1  # index into allowed exits (-1 = deepest)

    def decide(self, snapshot: QueueSnapshot) -> Optional[Decision]:
        nonempty = snapshot.nonempty()
        if not nonempty:
            return None
        m = max(nonempty, key=lambda i: (snapshot.qlen(i), snapshot.w_max(i)))
        batch = self.batch_size(snapshot.qlen(m))
        exit_idx = self._exits[self._pinned_exit]
        return Decision(
            model=m,
            exit_idx=exit_idx,
            batch_size=batch,
            predicted_latency=self.table(m, exit_idx, batch),
        )


class AllFinalScheduler(_FixedExitLQF):
    name = "all-final"
    _pinned_exit = -1


class AllEarlyScheduler(_FixedExitLQF):
    name = "all-early"
    _pinned_exit = 0


class SymphonyScheduler(Scheduler):
    """Deferred batching a la Symphony [7] (paper's strongest baseline).

    Each model queue is considered independently; a queue becomes *due* when
    its oldest request can only just finish within the SLO if dispatched now
    at the final exit (with a small headroom), or when a full batch has
    accumulated. Among due queues, the earliest-deadline queue is served.
    When nothing is due, the scheduler idles (deferred batching) and reports
    the next wake-up time so the runtime can sleep precisely.
    """

    name = "symphony"

    def __init__(
        self,
        table: ProfileTable,
        config: SchedulerConfig,
        headroom: float = 0.10,
    ):
        super().__init__(table, config)
        # headroom is a fraction of tau reserved for dispatch jitter.
        self.headroom = headroom * config.slo
        self._final = self._exits[-1]

    def _due(self, snapshot: QueueSnapshot, m: int) -> bool:
        batch = self.batch_size(snapshot.qlen(m))
        if batch >= self.config.max_batch:
            return True  # full batch: deferring further cannot help throughput
        lat = self.table(m, self._final, batch)
        tau = snapshot.oldest_tau(m, self.config.slo)
        return snapshot.w_max(m) + lat >= tau - self.headroom

    def decide(self, snapshot: QueueSnapshot) -> Optional[Decision]:
        nonempty = snapshot.nonempty()
        if not nonempty:
            return None
        due = [m for m in nonempty if self._due(snapshot, m)]
        if not due:
            return None  # defer; runtime sleeps until next_wake()
        # earliest effective deadline first among due queues
        m = min(
            due,
            key=lambda i: snapshot.oldest_tau(i, self.config.slo)
            - snapshot.w_max(i)
            - self.table(i, self._final, self.batch_size(snapshot.qlen(i))),
        )
        batch = self.batch_size(snapshot.qlen(m))
        return Decision(
            model=m,
            exit_idx=self._final,
            batch_size=batch,
            predicted_latency=self.table(m, self._final, batch),
        )

    def next_wake(self, snapshot: QueueSnapshot) -> Optional[float]:
        """Absolute time at which some queue first becomes due (or None)."""
        wakes = []
        for m in snapshot.nonempty():
            batch = self.batch_size(snapshot.qlen(m))
            lat = self.table(m, self._final, batch)
            tau = snapshot.oldest_tau(m, self.config.slo)
            slack = tau - self.headroom - lat - snapshot.w_max(m)
            wakes.append(snapshot.now + max(slack, 0.0))
        return min(wakes) if wakes else None

    def prune(self, snapshot: QueueSnapshot) -> "list[tuple[int, int]]":
        """Symphony sheds requests whose deadline has already passed when its
        deferred batching cannot keep pace with arrivals (paper Sec. I)."""
        drops = []
        for m in snapshot.nonempty():
            w = snapshot.waits[m]  # FIFO order: oldest (largest wait) first
            if snapshot.has_deadlines:
                # Per-task deadlines: shed the expired FIFO prefix (pop_batch
                # can only remove the oldest tasks).
                expired = w > snapshot.taus(m, self.config.slo)
                n = len(w) if expired.all() else int(np.argmin(expired))
            else:
                n = int(np.searchsorted(-w, -self.config.slo, side="left"))
            if n > 0:
                drops.append((m, n))
        return drops


class EarlyExitLQFScheduler(Scheduler):
    """Ablation: profile-based exit selection + longest-queue-first."""

    name = "earlyexit-lqf"

    def decide(self, snapshot: QueueSnapshot) -> Optional[Decision]:
        nonempty = snapshot.nonempty()
        if not nonempty:
            return None
        m = max(nonempty, key=lambda i: (snapshot.qlen(i), snapshot.w_max(i)))
        batch, exit_idx, lat = self.candidate(snapshot, m)
        return Decision(m, exit_idx, batch, lat)


class EarlyExitEDFScheduler(Scheduler):
    """Ablation: profile-based exit selection + earliest-deadline-first.

    EDF selects the model whose oldest queued task has the least remaining
    SLO slack (tau - w_max), ignoring the system-wide impact of serving it.
    """

    name = "earlyexit-edf"

    def decide(self, snapshot: QueueSnapshot) -> Optional[Decision]:
        nonempty = snapshot.nonempty()
        if not nonempty:
            return None
        m = min(
            nonempty,
            key=lambda i: snapshot.oldest_tau(i, self.config.slo)
            - snapshot.w_max(i),
        )
        batch, exit_idx, lat = self.candidate(snapshot, m)
        return Decision(m, exit_idx, batch, lat)


class AllFinalDeadlineAwareScheduler(EdgeServingScheduler):
    """Ablation: stability-score model selection, early exit disabled."""

    name = "allfinal-deadline-aware"

    def __init__(self, table: ProfileTable, config: SchedulerConfig):
        final_only = dataclasses.replace(
            config, allowed_exits=(table.num_exits - 1,)
        )
        super().__init__(table, final_only)


class NoBatchingScheduler(EdgeServingScheduler):
    """Ablation: full scheduler with dynamic batching disabled (B = 1)."""

    name = "ours-bs1"

    def __init__(self, table: ProfileTable, config: SchedulerConfig):
        super().__init__(table, dataclasses.replace(config, max_batch=1))


SCHEDULERS = {
    "edgeserving": EdgeServingScheduler,
    "edgeserving-lattice": LatticeEdgeServingScheduler,
    "all-final": AllFinalScheduler,
    "all-early": AllEarlyScheduler,
    "symphony": SymphonyScheduler,
    "earlyexit-lqf": EarlyExitLQFScheduler,
    "earlyexit-edf": EarlyExitEDFScheduler,
    "allfinal-deadline-aware": AllFinalDeadlineAwareScheduler,
    "ours-bs1": NoBatchingScheduler,
}


def make_scheduler(name: str, table: ProfileTable, config: SchedulerConfig) -> Scheduler:
    try:
        cls = SCHEDULERS[name]
    except KeyError:
        raise ValueError(
            f"unknown scheduler {name!r}; available: {sorted(SCHEDULERS)}"
        ) from None
    # config.lattice upgrades the flagship policy to the joint
    # (model, exit, batch) lattice; baselines/ablations are unaffected.
    if config.lattice and cls is EdgeServingScheduler:
        cls = LatticeEdgeServingScheduler
    return cls(table, config)
