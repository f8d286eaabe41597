"""Arrival processes: the seed-deterministic trace generators.

This slice carries the paper's stationary Poisson process (Sec. VI-A). The
numpy draws are the reference's, in the reference's order, so a trace for a
given seed is bitwise the reference's. Every generator emits
:class:`~repro_torch.core.request.Request` records sorted by arrival time
with monotone ``req_id``, and can stamp a per-queue SLO vector onto
``Request.deadline`` so heterogeneous deadlines flow end to end through
snapshot urgency, Eq. 6 and violation accounting.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.request import Request

__all__ = ["ArrivalProcess", "PoissonProcess"]


class ArrivalProcess:
    """Seed-deterministic generator of a merged, time-sorted Request trace.

    Args:
      rates:     per-model *mean* arrival rates (req/s); zero-rate models
                 receive no traffic.
      deadlines: optional per-model SLO vector (seconds); stamped onto each
                 generated request's ``deadline``. ``None`` keeps the global
                 SLO fallback (the paper's setting).
    """

    name = "base"

    def __init__(
        self,
        rates: Sequence[float],
        deadlines: Optional[Sequence[float]] = None,
    ):
        self.rates = [float(r) for r in rates]
        if deadlines is not None:
            deadlines = [float(d) for d in deadlines]
            assert len(deadlines) == len(self.rates), (
                "deadlines must give one SLO per model"
            )
        self.deadlines = deadlines

    @property
    def num_models(self) -> int:
        return len(self.rates)

    def mean_rate(self, m: int) -> float:
        """Long-run mean arrival rate of model ``m`` (req/s)."""
        return self.rates[m]

    def generate(
        self, horizon: float, seed: int = 0, data_pool: int = 10_000
    ) -> List[Request]:
        """Arrivals in ``[0, horizon)``, time-sorted, ``req_id`` monotone."""
        raise NotImplementedError

    def _finalize(self, events: List[tuple]) -> List[Request]:
        """``[(t, m, data_id)]`` -> sorted Request list with deadlines."""
        events.sort()
        dl = self.deadlines
        return [
            Request(
                req_id=i,
                model=m,
                arrival=t,
                data_id=int(d),
                deadline=None if dl is None else dl[m],
            )
            for i, (t, m, d) in enumerate(events)
        ]


class PoissonProcess(ArrivalProcess):
    """Stationary independent Poisson arrivals per model (the paper default):
    exponential gaps, vectorised with slack then trimmed."""

    name = "poisson"

    def _event_tuples(
        self, horizon: float, seed: int, data_pool: int
    ) -> List[tuple]:
        rng = np.random.default_rng(seed)
        events: List[tuple] = []
        for m, lam in enumerate(self.rates):
            if lam <= 0:
                continue
            # Expected count + slack, then trim: cheaper than a Python loop.
            n_expect = int(lam * horizon * 1.25 + 50)
            gaps = rng.exponential(1.0 / lam, size=n_expect)
            times = np.cumsum(gaps)
            while times[-1] < horizon:  # extremely unlikely; extend defensively
                extra = rng.exponential(1.0 / lam, size=n_expect)
                times = np.concatenate([times, times[-1] + np.cumsum(extra)])
            times = times[times < horizon]
            data = rng.integers(0, data_pool, size=len(times))
            events.extend(zip(times.tolist(), [m] * len(times), data.tolist()))
        return events

    def generate(
        self, horizon: float, seed: int = 0, data_pool: int = 10_000
    ) -> List[Request]:
        return self._finalize(self._event_tuples(horizon, seed, data_pool))
