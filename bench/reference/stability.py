"""Frozen float64 reference of the EdgeServing decision (paper Sec. V).

For one queue snapshot (each queue's waits, oldest first) and a latency
table ``L[m, e, b]`` over profiled batch sizes:

* Eq. 5: each non-empty queue serves ``B = min(|Q_m|, B_max)``;
* Eq. 6: at the deepest exit with ``w_max + L(m, e, B) <= tau``, else the
  shallowest; a batch between two profiled sizes takes the next larger
  one's latency;
* Eq. 3-4: urgency ``min(exp(w / tau - 1), C)``, summed over every task
  still queued after serving the candidate, each waiting ``L`` longer;
* Eq. 7: the candidate of least score.

Plain numpy; it imports nothing of the program.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np


def urgency(w: np.ndarray, tau: float, clip: float) -> np.ndarray:
    return np.minimum(np.exp(np.minimum(w / tau - 1.0, np.log(clip))), clip)


def latency(table: np.ndarray, batch_sizes: Sequence[int], m: int, e: int,
            b: int) -> float:
    i = min(int(np.searchsorted(np.asarray(batch_sizes), b)),
            len(batch_sizes) - 1)
    return float(table[m, e, i])


def candidates(waits: Sequence[np.ndarray], table: np.ndarray,
               batch_sizes: Sequence[int], slo: float, max_batch: int,
               clip: float) -> Dict[int, Tuple[int, int, float]]:
    """``{m: (exit, batch, score)}`` for each non-empty queue."""
    out = {}
    for m, w in enumerate(waits):
        if not len(w):
            continue
        b = min(len(w), max_batch)
        e_pick = 0
        for e in reversed(range(table.shape[1])):
            if float(w[0]) + latency(table, batch_sizes, m, e, b) <= slo:
                e_pick = e
                break
        lat = latency(table, batch_sizes, m, e_pick, b)
        score = 0.0
        for m2, w2 in enumerate(waits):
            rest = np.asarray(w2[b:] if m2 == m else w2, dtype=np.float64)
            if len(rest):
                score += float(urgency(rest + lat, slo, clip).sum())
        out[m] = (e_pick, b, score)
    return out


def off_choice(waits, table, batch_sizes, slo, max_batch, clip,
               pick: Tuple[int, int, int], rtol: float) -> bool:
    """Whether the decision ``pick = (model, exit, batch)`` is not one the
    reference would make: a wrong exit or batch for its queue, or a score
    above the least by more than ``rtol`` of it (float32 ties pass)."""
    cands = candidates(waits, table, batch_sizes, slo, max_batch, clip)
    m, e, b = pick
    if m not in cands or cands[m][:2] != (e, b):
        return True
    best = min(s for _, _, s in cands.values())
    return cands[m][2] - best > rtol * max(abs(best), 1e-30)
