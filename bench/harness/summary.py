"""The end-to-end arithmetic of a window, copied from the port's
``core/metrics.py::summarize_arrays`` and changed in two ways: every
request that arrived in the window counts (no warm-up completions are
dropped), and a request that was shed or never finished is ``failed``,
missing its deadline by definition."""

from __future__ import annotations

from typing import Sequence

import numpy as np


def summarize(n_arrivals: int, latencies: Sequence[float],
              queueings: Sequence[float], exits: Sequence[int],
              batches: Sequence[int], taus: Sequence[float],
              seconds: float) -> dict:
    """``latencies`` (finish - scheduled arrival), ``queueings`` (dispatch
    - arrival), ``exits``, ``batches`` and ``taus`` (each request's
    deadline) of the completed requests; ``n_arrivals`` requests arrived
    in a window of ``seconds``."""
    lat = np.asarray(latencies, dtype=np.float64)
    queue = np.asarray(queueings, dtype=np.float64)
    exits = np.asarray(exits, dtype=np.int64)
    batches = np.asarray(batches, dtype=np.int64)
    taus = np.asarray(taus, dtype=np.float64)
    done = len(lat)
    met = int(np.sum(lat <= taus))
    out = {
        "arrivals": int(n_arrivals),
        "completed": done,
        "failed": int(n_arrivals) - done,
        "met_deadline": met,
        "offered_req_s": n_arrivals / seconds,
        "goodput_req_s": met / seconds,
        "violation_ratio": (1.0 - met / n_arrivals) if n_arrivals else 0.0,
    }
    if done:
        p50, p95, p99 = np.percentile(lat, [50, 95, 99])
        out.update(
            p50_ms=1e3 * float(p50), p95_ms=1e3 * float(p95),
            p99_ms=1e3 * float(p99),
            mean_queue_ms=1e3 * float(queue.mean()),
            mean_exit_depth=float(exits.mean() + 1.0),
            mean_batch=float(batches.mean()))
    return out


def per_model(models: Sequence[int], latencies: Sequence[float],
              exits: Sequence[int], taus: Sequence[float],
              arrivals_per_model: Sequence[int],
              seconds: float) -> list:
    """Goodput, P95 and exit depth of each model's queue."""
    models = np.asarray(models, dtype=np.int64)
    lat = np.asarray(latencies, dtype=np.float64)
    exits = np.asarray(exits, dtype=np.int64)
    taus = np.asarray(taus, dtype=np.float64)
    rows = []
    for m, n in enumerate(arrivals_per_model):
        sel = models == m
        row = {"model": m, "arrivals": int(n), "completed": int(sel.sum()),
               "goodput_req_s": float(np.sum(lat[sel] <= taus[sel])) / seconds}
        if sel.any():
            row["p95_ms"] = 1e3 * float(np.percentile(lat[sel], 95))
            row["mean_exit_depth"] = float(exits[sel].mean() + 1.0)
        rows.append(row)
    return rows

