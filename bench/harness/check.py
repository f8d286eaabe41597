"""The comparison that decides ``correct``.

Numbers compared, each with its limit:

* ``token_gap``: over a sample of the window's served quanta, drawn from
  the seed, that holds at least one quantum of every (model, exit, batch)
  served and then more, to the configuration's ``check_rows``: the widest
  gap by which a served token's logit lies below the best logit of the
  plain float32 reference (``reference/lm.py``) run over the same prompt
  through the same exit. Limit: the configuration's.
* ``lse_gap``: the widest distance between the served logsumexp and the
  reference's, over the same rows. Limit: the configuration's.
* ``max_gap``: the widest distance between the served max logit and the
  reference's, over the same rows. Limit: the configuration's.
* ``decision_errors``: rounds whose decision the float64 reference
  (``reference/stability.py``) would not make from the same snapshot and
  profile: a wrong exit or batch, or a score above the least by more than
  float32 rounding (``TIE_RTOL``). Exact: limit 0.
* ``launch_errors`` (on the card): how far the launches of rmsnorm, flash
  attention, the exit head and the stability score lie from what the
  decisions imply (``launches.py``). Exact: limit 0.
* ``accounting_errors``: arrivals not accounted once as completed,
  dropped, queued or never submitted; duplicate or unknown completions;
  decisions' batches that do not sum to the completions. Exact: limit 0.

With ``control`` the reference in float8 takes the program's place: its
token is the one it puts first, its logsumexp and max its own, each read
against the float32 reference.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from harness.deploy import Deployment, Quantum
from reference import lm as ref_lm
from reference import stability

TIE_RTOL = 1e-5


def sample_quanta(quanta: Sequence[Quantum], rows: int,
                  rng: np.random.Generator) -> List[Quantum]:
    """One quantum of every (model, exit, batch) served, then more at
    random until the sample holds ``rows`` rows."""
    order = rng.permutation(len(quanta))
    picked, seen, n_rows = set(), set(), 0
    for i in order:
        q = quanta[i]
        key = (q.model, q.exit_idx, q.batch)
        if key not in seen:
            seen.add(key)
            picked.add(i)
            n_rows += q.batch
    for i in order:
        if n_rows >= rows:
            break
        if i not in picked:
            picked.add(i)
            n_rows += quanta[i].batch
    return [quanta[i] for i in sorted(picked)]


def output_gaps(dep: Deployment, sample: Sequence[Quantum],
                control: bool = False
                ) -> Dict[str, Tuple[float, float, float]]:
    """``{"program": (token_gap, lse_gap, max_gap)}`` of the sampled
    quanta, and with ``control`` the same for the float8 reference put in
    the program's place, on the same rows."""
    ref_lm.strict_float32()
    sides = ["program"] + (["control"] if control else [])
    gaps = {side: [0.0, 0.0, 0.0] for side in sides}
    for m, lm in enumerate(dep.lms):
        mine = [q for q in sample if q.model == m]
        if not mine:
            continue
        pool = dep.pools[m]
        idx = torch.cat([torch.arange(q.start, q.start + q.batch)
                         for q in mine]).to(pool.tokens.device)
        exits = [q.exit_idx for q in mine for _ in range(q.batch)]
        src = None if pool.src is None else pool.src[idx]
        answers = {"program": (
            [int(t) for q in mine for t in q.out[0].tolist()],
            [float(x) for q in mine for x in q.out[2].tolist()],
            [float(x) for q in mine for x in q.out[1].tolist()])}
        with torch.inference_mode():
            ref = ref_lm.exit_logits(dep.weights[m], lm, pool.tokens[idx],
                                     exits, src=src)
            if control:
                low = ref_lm.exit_logits(dep.weights[m], lm, pool.tokens[idx],
                                         exits, src=src, fp8=True)
                answers["control"] = (
                    [int(x.argmax()) for x in low],
                    [float(torch.logsumexp(x, 0)) for x in low],
                    [float(x.max()) for x in low])
        for r, logits in enumerate(ref):
            best = float(logits.max())
            ref_lse = float(torch.logsumexp(logits, 0))
            for side in sides:
                tokens, lses, maxes = answers[side]
                g = gaps[side]
                tok = tokens[r]
                if not 0 <= tok < logits.shape[0]:
                    g[0] = float("inf")
                    continue
                g[0] = max(g[0], best - float(logits[tok]))
                g[1] = max(g[1], abs(lses[r] - ref_lse))
                g[2] = max(g[2], abs(maxes[r] - best))
    return {side: tuple(g) for side, g in gaps.items()}


def decision_errors(rounds, table, slo: float, max_batch: int,
                    clip: float) -> int:
    lat = np.asarray(table.latency, dtype=np.float64)
    bs = list(table.batch_sizes)
    bad = 0
    for snapshot, d in rounds:
        waits = [np.asarray(w, dtype=np.float64) for w in snapshot.waits]
        if stability.off_choice(waits, lat, bs, slo, max_batch, clip,
                                (d.model, d.exit_idx, d.batch_size),
                                TIE_RTOL):
            bad += 1
    return bad


def launch_errors(launches: Dict[str, int], want: Dict[str, int]) -> int:
    return sum(abs(launches.get(k, 0) - n) for k, n in want.items())


def accounting_errors(n_arrivals: int, completions, dropped: int,
                      queued: int, unsubmitted: int,
                      decided_batches: int) -> int:
    ids = [c.req_id for c in completions]
    dup = len(ids) - len(set(ids))
    unknown = sum(1 for i in ids if not 0 <= i < n_arrivals)
    lost = abs(n_arrivals - len(ids) - dropped - queued - unsubmitted)
    return lost + dup + unknown + abs(decided_batches - len(ids))
