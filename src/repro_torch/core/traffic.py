"""Traffic models (paper Sec. VI-A).

Arrivals to each service queue are independent Poisson point processes.
The paper's default rate ratio is ``lambda_50 : lambda_101 : lambda_152
= 3 : 2 : 1`` (lighter models receive heavier traffic); the model-combination
study uses equal rates.

``poisson_arrivals`` delegates to
:class:`repro_torch.core.workloads.PoissonProcess` (the reference's
algorithm and numpy draws, so traces are bitwise the reference's per seed).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from repro_torch.core.request import Request
from repro_torch.core.workloads import PoissonProcess


def poisson_arrivals(
    rates: Sequence[float],
    horizon: float,
    seed: int = 0,
    data_pool: int = 10_000,
    deadlines: Optional[Sequence[float]] = None,
) -> List[Request]:
    """Generate a merged, time-sorted arrival trace.

    Args:
      rates:   per-model arrival rates (req/s); zero-rate models get none.
      horizon: generate arrivals in [0, horizon) seconds.
      seed:    PRNG seed (deterministic traces for reproducible experiments).
      data_pool: data ids are drawn uniformly from [0, data_pool) -- the
        paper draws each request i.i.d. from the CIFAR-100 test set.
      deadlines: optional per-model SLO vector stamped onto each request's
        ``deadline`` (heterogeneous-SLO serving); None = global SLO.
    Returns: list of Requests sorted by arrival time, req_id in that order.
    """
    return PoissonProcess(rates, deadlines=deadlines).generate(
        horizon, seed=seed, data_pool=data_pool
    )


def paper_rate_vector(lambda_152: float, ratio: Sequence[float] = (3, 2, 1)) -> List[float]:
    """Paper default: rates proportional to ``ratio`` with the *last* model
    (ResNet152) pinned to ``lambda_152`` -- i.e. (3x, 2x, x)."""
    unit = lambda_152 / ratio[-1]
    return [unit * r for r in ratio]
