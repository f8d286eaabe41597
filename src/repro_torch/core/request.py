"""Request / decision / completion record types for the EdgeServing core.

These are deliberately tiny, allocation-cheap host-side records: the online
scheduler runs on the host between accelerator quanta, so every byte and
branch here is on the serving critical path.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(slots=True)
class Request:
    """A single inference request enqueued to a model's service queue.

    Attributes:
      req_id:    globally unique, monotone id (also used as FIFO tiebreak).
      model:     index of the target model queue in ``[0, M)``.
      arrival:   arrival wall-clock time in seconds.
      data_id:   opaque payload index (e.g. CIFAR test index / prompt id).
      deadline:  optional per-request latency budget in seconds (relative to
                 ``arrival``). ``None`` means "use the global SLO tau" — the
                 paper's single-deadline setting. Workload scenarios attach
                 per-queue SLO vectors here (see ``repro_torch.core.workloads``),
                 and the value flows through snapshot urgency, Eq. 6
                 feasibility, and violation accounting end to end.
    """

    req_id: int
    model: int
    arrival: float
    data_id: int = 0
    deadline: Optional[float] = None


@dataclasses.dataclass(slots=True)
class Decision:
    """A scheduling decision ``(m*, e*, B*)`` (paper Eq. 5-7).

    Attributes:
      model:      selected model queue ``m*``.
      exit_idx:   selected early-exit point ``e*`` as an index into the
                  model's exit list (0 = shallowest, E-1 = final).
      batch_size: selected batch size ``B*`` (number of requests dequeued).
      predicted_latency: profile-table latency ``L(m*, e*, B*)`` in seconds.
      stability_score:   predicted system stability score ``S_{m*}`` under
                  this decision (lower = more stable); NaN for schedulers
                  that do not compute one.
    """

    model: int
    exit_idx: int
    batch_size: int
    predicted_latency: float
    stability_score: float = float("nan")


@dataclasses.dataclass(slots=True)
class Completion:
    """A completed request with its end-to-end accounting.

    ``total_latency = queueing + service`` (paper Eq. 1):
    ``T_i = w_i + t_i``.
    """

    req_id: int
    model: int
    arrival: float
    dispatch: float
    finish: float
    exit_idx: int
    batch_size: int
    deadline: Optional[float] = None  # per-request SLO override (seconds)

    @property
    def queueing(self) -> float:
        return self.dispatch - self.arrival

    @property
    def service(self) -> float:
        return self.finish - self.dispatch

    @property
    def total_latency(self) -> float:
        return self.finish - self.arrival

    def violates(self, slo: float) -> bool:
        """Deadline check: the request's own deadline wins over the global
        ``slo`` when set (heterogeneous-SLO workloads)."""
        tau = self.deadline if self.deadline is not None else slo
        return self.total_latency > tau


@dataclasses.dataclass(slots=True)
class ServingTrace:
    """One dispatched accelerator quantum (for timelines / debugging)."""

    t_start: float
    t_end: float
    decision: Decision
    queue_lengths: Optional[tuple] = None
