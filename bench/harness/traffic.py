"""The benchmark's one arrival generator, driven by a traffic file.

A traffic file (``bench/traffic/<name>.json``) gives the process and the
load: ``{"process": "poisson", "load": 0.8}``. The configuration gives the
knee rate and the split between its models, and the cell's rate is
``load * knee``, split in proportion to the models' shares.

Each model's arrivals are a Poisson process conditioned on its count: the
count is ``round(rate * horizon)`` for every seed, and the arrival times
are drawn uniform on ``[0, horizon)``, as a Poisson process places them
once its count is known. So seeds differ in when requests come, not in
how many, and every seed gives the window the same amount of work.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from repro_torch.core.request import Request

PROCESS = "poisson"


def model_rates(traffic: dict, knee_req_s: float,
                split: Sequence[float]) -> List[float]:
    """Per-model mean rates: ``load * knee`` split in proportion."""
    share = np.asarray(split, dtype=np.float64)
    total = float(traffic["load"]) * float(knee_req_s)
    return (total * share / share.sum()).tolist()


def events(traffic: dict, rates: Sequence[float], horizon: float, seed: int,
           data_pool: int = 10_000) -> List[tuple]:
    """Unsorted ``[(t, model, data_id)]`` arrivals in ``[0, horizon)``."""
    if traffic.get("process") != PROCESS:
        raise ValueError(f"traffic {traffic} names another process than "
                         f"{PROCESS!r}")
    rng = np.random.default_rng(seed)
    out = []
    for m, lam in enumerate(rates):
        n = int(round(lam * horizon)) if lam > 0 else 0
        times = rng.uniform(0.0, horizon, size=n)
        data = rng.integers(0, data_pool, size=n)
        out.extend(zip(times.tolist(), [m] * n, data.tolist()))
    return out


def arrivals(traffic: dict, rates: Sequence[float], horizon: float,
             seed: int, data_pool: int = 10_000,
             first_id: int = 0) -> List[Request]:
    """Time-sorted requests with monotone ``req_id`` from ``first_id`` (the
    port's ``ArrivalProcess._finalize`` order: by time, then model, then
    data)."""
    evs = events(traffic, rates, horizon, seed, data_pool)
    evs.sort()
    return [Request(req_id=first_id + i, model=m, arrival=t, data_id=int(d))
            for i, (t, m, d) in enumerate(evs)]
